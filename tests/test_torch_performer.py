"""The port's Performer (CPU) against the JAX package's through the weight
bridge: whole-model logits, batch-position decode logits, and the port's own
decode == forward.  Logit tolerance: rtol 2e-4 / atol 1e-4 (the JAX suite's
op tolerance, with atol raised for two layers plus the vocabulary head)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.models.performer import MusicPerformer as JaxPerformer
from emo_disentanger_tpu_torch.utils.precision import cast_params
from torch_port_helpers import SMALL, model_pair

V = 40
RTOL, ATOL = 2e-4, 1e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _tokens(rng, B, L):
    return (rng.randint(0, V - 1, (B, L)).astype(np.int32),
            rng.randint(0, 2, (B, L)).astype(np.int32))


@pytest.mark.parametrize('L,interpret', [(41, False), (64, True)],
                         ids=['composed-odd-L', 'pallas-interpret'])
def test_forward_logits_match_jax(L, interpret, monkeypatch):
    if interpret:
        monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1')
    jm, params, jom, tm, tom = model_pair(V, seed=0)
    tok, seg = _tokens(np.random.RandomState(0), 2, L)
    want = jm.apply(params, jnp.asarray(tok), jom, jnp.asarray(seg))
    with torch.no_grad():
        got = tm(torch.from_numpy(tok).long(), tom, torch.from_numpy(seg).long())
        last = tm(torch.from_numpy(tok).long(), tom,
                  torch.from_numpy(seg).long(), keep_last_only=True)
    assert got.dtype == torch.float32 and got.shape == (2, L, V)
    _close(got, want)
    _close(last, np.asarray(want)[:, -1])


def test_batchpos_decode_logits_match_jax():
    """24 steps with per-element clocks and a random update mask (frozen
    elements do not advance their clock, as in the generator)."""
    jm, params, jom, tm, tom = model_pair(V, seed=1)
    B = 3
    rng = np.random.RandomState(1)
    jstate = jm.apply(params, B, 'dm', method=JaxPerformer.init_decode_state)
    tstate = tm.init_decode_state(B)
    t = np.array([0, 5, 11], np.int32)
    for _ in range(24):
        tok = rng.randint(0, V - 1, B).astype(np.int32)
        seg = rng.randint(0, 2, B).astype(np.int32)
        mask = rng.rand(B) > 0.25
        want, jstate = jm.apply(params, jnp.asarray(tok), jnp.asarray(seg),
                                jnp.asarray(t), jom, jstate,
                                update_mask=jnp.asarray(mask),
                                method=JaxPerformer.decode_step_batchpos)
        with torch.no_grad():
            got, tstate = tm.decode_step_batchpos(
                torch.from_numpy(tok).long(), torch.from_numpy(seg).long(),
                torch.from_numpy(t).long(), tom, tstate,
                update_mask=torch.from_numpy(mask))
        _close(got, want)
        t = t + mask
    _close(tstate['S'], jstate['S'])
    _close(tstate['z'], jstate['z'])


@torch.no_grad()
def test_decode_equals_forward():
    _, _, _, tm, tom = model_pair(V, seed=2)
    tok, seg = (torch.from_numpy(a).long()
                for a in _tokens(np.random.RandomState(2), 2, 30))
    full = tm(tok, tom, seg)
    with pytest.raises(ValueError, match="unknown state_layout 'mm'"):
        tm.init_decode_state(2, 'mm')
    for layout in ('dm', 'md'):                 # S [.., Dh, M] / [.., M, Dh]
        state = tm.init_decode_state(2, layout)
        steps = [tm.decode_step(tok[:, t], seg[:, t], t, tom, state, layout)[0]
                 for t in range(30)]
        _close(torch.stack(steps, 1), full)


def test_state_dict_names_follow_the_reference_checkpoint():
    """The bridge fills every parameter under the reference names; the
    positional table is a non-persistent buffer."""
    _, _, _, tm, _ = model_pair(V, seed=0)
    keys = set(tm.state_dict())
    assert 'pe' not in keys
    assert {'token_emb.emb_lookup.weight', 'segemb.emb_lookup.weight',
            'dec_out_proj.weight', 'dec_out_proj.bias',
            'transformer_decoder.decoder_layers.1.attention.query_projection.weight',
            'transformer_decoder.decoder_layers.0.norm2.bias'} <= keys
    assert len(keys) == 4 + SMALL['n_layer'] * 16


@torch.no_grad()
def test_cast_params_serves_in_bf16():
    """cast_params casts parameters only: the PE buffer and the omegas stay
    f32, the logits come out f32 and close to the f32 model's (bf16
    rounding through two layers: 5e-2 of the largest logit)."""
    _, _, _, tm, tom = model_pair(V, seed=5)
    tok, seg = (torch.from_numpy(a).long()
                for a in _tokens(np.random.RandomState(5), 2, 16))
    ref = tm(tok, tom, seg)
    cast_params(tm)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert tm.pe.dtype == torch.float32 and tom.dtype == torch.float32
    got = tm(tok, tom, seg)
    assert got.dtype == torch.float32
    assert (got - ref).abs().max() <= 5e-2 * ref.abs().max()
    state = tm.init_decode_state(2)
    logits, _ = tm.decode_step(tok[:, 0], seg[:, 0], 0, tom, state)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
