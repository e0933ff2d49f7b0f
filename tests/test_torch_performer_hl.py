"""The heads-last Performer configuration (``EMODIS_HL_ATTN=1``): the port's
``SMALL`` model with ``heads_last=True`` against the JAX model with the
variable set (its heads-last kernels #8-#11 in interpret mode), logits,
loss and every parameter's gradient through the weight bridge; the port's
two layouts equal on the same weights; and the variable choosing the
layout when the keyword is None."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.ops import linear_attention as jla
from emo_disentanger_tpu.train import trainer as jtr
from emo_disentanger_tpu_torch.convert import flax_performer_to_torch
from emo_disentanger_tpu_torch.models import MusicPerformer
from emo_disentanger_tpu_torch.train import trainer as ttr
from torch_port_helpers import ATOL, RTOL, SMALL, model_pair, one_torch_thread  # noqa: F401

V = 23
PAD = V - 1
# gradients through two layers: the JAX suite's gradient tolerance
# (tests/test_linear_attention.py:158-175), relative to each tensor's largest
GRAD_RTOL = 2e-3


def _batch(seed, B=2, L=136):
    """L=136: a full 128-row chunk of the JAX kernels and a ragged one."""
    rng = np.random.RandomState(seed)
    tgt = rng.randint(0, V - 1, (B, L))
    tgt[rng.rand(B, L) < 0.3] = PAD
    return {'dec_inp': rng.randint(0, V - 1, (B, L)), 'dec_tgt': tgt,
            'track_mask': rng.randint(0, 2, (B, L)),
            'chord_idx': rng.randint(0, 2, (B, L)),
            'melody_idx': rng.randint(0, 2, (B, L))}


def test_heads_last_model_matches_jax(monkeypatch):
    """Both models read EMODIS_HL_ATTN=1: the port's when it is built (the
    keyword is None), JAX's while it traces this fresh loss closure."""
    monkeypatch.setenv('EMODIS_HL_ATTN', '1')
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1')
    jm, jp, jom, tm, tom = model_pair(V, seed=3)
    assert all(layer.heads_last for layer in tm.layers)
    batch = _batch(4)
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    calls = []
    real = jla.favor_causal_attention_heads_last
    monkeypatch.setattr(jla, 'favor_causal_attention_heads_last',
                        lambda *a: calls.append(1) or real(*a))
    (want, _), jg = jax.value_and_grad(jtr.stage2_performer_loss_fn(jm, PAD),
                                       has_aux=True)(jp, jbatch, None,
                                                     {'omegas': jom})
    assert len(calls) >= SMALL['n_layer']           # JAX took its HL path
    tbatch = ttr.batch_to_device(batch, 'cpu')
    logits = tm(tbatch['dec_inp'], tom, tbatch['track_mask'])
    jlogits = jm.apply(jp, jbatch['dec_inp'], jom, jbatch['track_mask'])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=1e-4)
    loss, _ = ttr.stage2_performer_loss_fn(tm, PAD)(tbatch, {'omegas': tom})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    ref = flax_performer_to_torch(jax.tree.map(np.asarray, jg), SMALL['n_layer'])
    for name, p in tm.named_parameters():
        got, exp = p.grad.numpy(), ref[name].numpy()
        err = float(np.abs(got - exp).max())
        assert err <= GRAD_RTOL * float(np.abs(exp).max()) + 1e-9, (name, err)


def test_layouts_equal_on_the_same_weights():
    """heads_last=True and False give the same logits and gradients, bit
    for bit: the same plain versions run on the same rows."""
    batch = ttr.batch_to_device(_batch(5, L=50), 'cpu')
    out = []
    for heads_last in (True, False):
        model = MusicPerformer(n_token=V, dropout=0.0, heads_last=heads_last,
                               device='cpu', **SMALL)
        omegas = model.draw_omegas(torch.Generator().manual_seed(1))
        loss, _ = ttr.stage2_performer_loss_fn(model, PAD)(batch,
                                                           {'omegas': omegas})
        loss.backward()
        out.append((loss.detach(),
                    {n: p.grad for n, p in model.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for name, g in out[0][1].items():
        assert torch.equal(g, out[1][1][name]), name


@pytest.mark.parametrize('env,keyword,want', [
    (None, None, False), ('0', None, False), ('1', None, True),
    ('1', False, False), (None, True, True)])
def test_env_selects_the_layout_when_the_keyword_is_none(env, keyword, want,
                                                        monkeypatch):
    if env is None:
        monkeypatch.delenv('EMODIS_HL_ATTN', raising=False)
    else:
        monkeypatch.setenv('EMODIS_HL_ATTN', env)
    model = MusicPerformer(n_token=V, heads_last=keyword, device='cpu', **SMALL)
    monkeypatch.setenv('EMODIS_HL_ATTN', '0' if want else '1')    # read once
    assert model.heads_last is want
    assert all(layer.heads_last is want for layer in model.layers)
    assert list(model.state_dict()) == list(MusicPerformer(
        n_token=V, heads_last=not want, device='cpu', **SMALL).state_dict())
