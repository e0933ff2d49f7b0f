"""Shared set-up for the PyTorch port's tests: the JAX Performer and its port
built from one set of numpy-seeded weights through the weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.models import MusicPerformer as JaxPerformer
from emo_disentanger_tpu_torch.convert import flax_performer_to_torch
from emo_disentanger_tpu_torch.models import MusicPerformer as TorchPerformer

SMALL = dict(n_layer=2, n_head=2, d_model=32, d_ff=64, d_embed=32,
             favor_dims=16)

# f32 tolerances of the JAX suite for one op (tests/test_linear_attention.py)
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Autouse in the modules that import it: one intra-op thread while a
    test steps a small model op by op.  Many threads gain nothing on such
    ops, and with several test workers on the cores they oversubscribe them
    and slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fill_params(params, seed: int, std: float):
    """Replace every leaf with numpy draws: LayerNorm scales N(1, std),
    everything else N(0, std)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        draw = rng.randn(*leaf.shape).astype(np.float32) * std
        return jnp.asarray(1.0 + draw if path[-1].key == 'scale' else draw)
    return jax.tree_util.tree_map_with_path(fill, params)


def model_pair(n_token: int, *, seed: int = 0, std: float = 0.05,
               omega_seed: int = 1, bias_fn=None):
    """(jax_model, jax_params, jax_omegas, torch_model, torch_omegas) with
    the same weights.  ``bias_fn`` may edit the vocabulary head's bias
    (numpy [V]) before both models take it."""
    jm = JaxPerformer(n_token=n_token, dropout=0.0, **SMALL)
    jom = jm.draw_omegas(jax.random.PRNGKey(omega_seed))
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32), jom,
                     jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.array, fill_params(params, seed, std))
    if bias_fn is not None:
        bias_fn(params['params']['out_proj']['bias'])
    tm = TorchPerformer(n_token=n_token, dropout=0.0, device='cpu', **SMALL)
    tm.load_state_dict(flax_performer_to_torch(params, SMALL['n_layer']))
    params = jax.tree.map(jnp.asarray, params)
    return jm, params, jom, tm.eval(), torch.from_numpy(np.array(jom))


GPT2_SMALL = dict(n_layer=2, n_head=4, d_model=64, d_ff=128, d_embed=64)


def gpt2_pair(n_token: int, *, seed: int = 0, std: float = 0.05,
              bias_fn=None, **shape):
    """(jax_model, jax_params, torch_model) of the stage-2 GPT-2 with the
    same numpy-drawn weights (``GPT2_SMALL`` unless ``shape`` overrides it),
    dropout 0, the torch model in eval mode.  ``bias_fn`` may edit the
    vocabulary head's bias (numpy [V]) first."""
    from emo_disentanger_tpu.models import MusicGPT2 as JaxGPT2
    from emo_disentanger_tpu_torch.convert import flax_gpt2_to_torch
    from emo_disentanger_tpu_torch.models import MusicGPT2 as TorchGPT2
    kw = dict(GPT2_SMALL, **shape)
    jm = JaxGPT2(n_token=n_token, dropout=0.0, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
                     jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.array, fill_params(params, seed, std))
    if bias_fn is not None:
        bias_fn(params['params']['out_proj']['bias'])
    tm = TorchGPT2(n_token=n_token, dropout=0.0, device='cpu', **kw)
    tm.load_state_dict(flax_gpt2_to_torch(params, kw['n_layer']))
    return jm, jax.tree.map(jnp.asarray, params), tm.eval()
