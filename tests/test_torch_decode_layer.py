"""The port's decode layer (``fused_decode_layer``, plain version on the
CPU) against the JAX package's: its whole-layer Pallas kernel in interpret
mode (which carries S in 'md', as the port does with ``state_layout='md'``)
and its composed path in both layouts, over a 5-step roll with a random update mask.
f32 at the JAX suite's op tolerance, rtol 2e-4 / atol 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.models.performer import MusicPerformer as JaxPerformer
from emo_disentanger_tpu_torch.ops.performer_decode import fused_decode_layer
from torch_port_helpers import ATOL, RTOL, SMALL, model_pair

B = 4


def _jax_roll(jm, params, omegas, x, state, mask, fused, layout):
    def roll(mdl, x, state, mask):
        S_all, z_all = state['S'], state['z']
        h = x
        for i, layer in enumerate(mdl.layers):
            h, S_all, z_all = layer.decode_step(
                h, omegas[i], i, S_all, z_all, update_mask=mask, fused=fused,
                state_layout=layout)
        return h, {'S': S_all, 'z': z_all}
    return jm.apply(params, x, state, mask, method=roll)


@pytest.mark.parametrize('fused,layout',
                         [(True, 'md'), (False, 'dm'), (False, 'md')],
                         ids=['pallas-interpret', 'composed-dm', 'composed-md'])
@torch.no_grad()
def test_decode_layer_matches_jax(fused, layout):
    jm, params, jom, tm, tom = model_pair(48, seed=3)
    jstate = jm.apply(params, B, layout, method=JaxPerformer.init_decode_state)
    tstate = tm.init_decode_state(B, layout)
    rng = np.random.RandomState(0)
    for _ in range(5):
        x = rng.randn(B, SMALL['d_model']).astype(np.float32)
        mask = rng.rand(B) > 0.3
        jh, jstate = _jax_roll(jm, params, jom, jnp.asarray(x)[:, None],
                               jstate, jnp.asarray(mask), fused, layout)
        h = torch.from_numpy(x)
        for i, layer in enumerate(tm.layers):
            h = fused_decode_layer(h, tstate['S'][i], tstate['z'][i],
                                   layer.decode_params(), tom[i],
                                   torch.from_numpy(mask), n_head=SMALL['n_head'],
                                   state_layout=layout)
        for got, want in ((h, np.asarray(jh)[:, 0]),
                          (tstate['S'], jstate['S']), (tstate['z'], jstate['z'])):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)


@torch.no_grad()
def test_masked_elements_keep_their_state():
    """update_mask=False leaves S and z bit-identical, in place."""
    _, _, _, tm, tom = model_pair(48, seed=4)
    state = tm.init_decode_state(B)
    rng = np.random.RandomState(1)
    layer = tm.layers[0]
    S, z = state['S'][0], state['z'][0]
    x = torch.from_numpy(rng.randn(B, SMALL['d_model']).astype(np.float32))
    fused_decode_layer(x, S, z, layer.decode_params(), tom[0], n_head=2)
    S0, z0 = S.clone(), z.clone()
    mask = torch.tensor([True, False, True, False])
    fused_decode_layer(x, S, z, layer.decode_params(), tom[0], mask, n_head=2)
    assert torch.equal(S[~mask], S0[~mask]) and torch.equal(z[~mask], z0[~mask])
    assert not torch.equal(S[mask], S0[mask])
