"""The port's stage-2 GPT-2 (CPU) against the JAX package: the flash-attention
plain version against JAX's library TPU kernel in interpret mode, the
forward (logits and the per-layer k/v), the KV-cache decode with
per-element clocks, gradients through the weight bridge, and the reference
checkpoint's names.  Tolerances are relative to the largest reference
magnitude: 1e-5 for attention and the f32 model (summation order only) and
2e-3 for gradients through two layers (the JAX suite's gradient tolerance,
as ``test_torch_train.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

from emo_disentanger_tpu.models import MusicGPT2 as JaxGPT2
from emo_disentanger_tpu.ops.attention import write_row_pe as jax_write_row_pe
from emo_disentanger_tpu.train.convert_pt import convert_gpt2_pt
from emo_disentanger_tpu_torch.convert import flax_gpt2_to_torch
from emo_disentanger_tpu_torch.models import gpt2 as tgpt2
from emo_disentanger_tpu_torch.models import MusicGPT2
from emo_disentanger_tpu_torch.ops import attention as tattn
from emo_disentanger_tpu_torch.ops import flash_attention as tflash
from torch_port_helpers import GPT2_SMALL, gpt2_pair, one_torch_thread  # noqa: F401

V = 40
TOL = 1e-5
GRAD_RTOL = 2e-3


def _close(got, want, tol=TOL, what=''):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _tokens(rng, B, L):
    return (rng.randint(0, V - 1, (B, L)).astype(np.int32),
            rng.randint(0, 2, (B, L)).astype(np.int32))


@pytest.mark.parametrize('shape', [(1, 2, 256, 64), (2, 2, 512, 64)],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_flash_plain_matches_library_kernel_interpret(shape):
    """The plain version against the library's TPU kernel run in interpret
    mode (default 128 blocks), f32, sm_scale 1/8."""
    rng = np.random.RandomState(sum(shape))
    q, k, v = (rng.randn(*shape).astype(np.float32) * 0.5 for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, sm_scale=0.125)
    got = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=True, sm_scale=0.125)
    assert got.dtype == torch.float32
    _close(got, want)


def test_flash_refuses_non_causal():
    x = torch.zeros(1, 1, 64, 64)
    with pytest.raises(ValueError, match='causal'):
        tflash.flash_attention(x, x, x, causal=False, sm_scale=0.125)


@pytest.mark.parametrize('L', [8, 256])
def test_forward_logits_and_kv_match_jax(L):
    jm, params, tm = gpt2_pair(V, seed=0)
    tok, seg = _tokens(np.random.RandomState(L), 2, L)
    want, wk, wv = jm.apply(params, jnp.asarray(tok), jnp.asarray(seg),
                            return_kv=True)
    with torch.no_grad():
        got, gk, gv = tm(torch.from_numpy(tok).long(),
                         torch.from_numpy(seg).long(), return_kv=True)
        last = tm(torch.from_numpy(tok).long(), torch.from_numpy(seg).long(),
                  keep_last_only=True)
    assert got.dtype == torch.float32 and got.shape == (2, L, V)
    assert gk.shape == (GPT2_SMALL['n_layer'], 2, L, 4, 16)
    _close(got, want, what='logits')
    _close(last, np.asarray(want)[:, -1], what='last logits')
    _close(gk, wk, what='k')
    _close(gv, wv, what='v')


def test_flash_dispatch_matches_einsum_path(monkeypatch):
    """The kernel's route through the block (head transposes, the f32 cast
    and back) against the einsum path: on the CPU the dispatch is told that
    the device qualifies, so flash_attention runs its plain version, once a
    layer, only in eval mode and only for L >= 512 with L % 128 == 0."""
    _, _, tm = gpt2_pair(V, seed=1, n_head=1)            # d_head 64
    tok, seg = (torch.from_numpy(a).long()
                for a in _tokens(np.random.RandomState(1), 1, 512))
    with torch.no_grad():
        want = tm(tok, seg)
        calls = []
        real = tgpt2.flash_attention
        monkeypatch.setattr(tgpt2, '_flash_applies', lambda training, q: (
            not training and q.shape[1] >= 512 and q.shape[1] % 128 == 0))
        monkeypatch.setattr(tgpt2, 'flash_attention',
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
        got = tm(tok, seg)
        assert len(calls) == GPT2_SMALL['n_layer']
        tm(tok[:, :500], seg[:, :500])                   # L % 128 != 0
        tm(tok[:, :384], seg[:, :384])                   # L < 512
        tm.train()
        tm(tok, seg)                                     # attention dropout
        assert len(calls) == GPT2_SMALL['n_layer']
    _close(got, want)


def test_write_row_pe_matches_jax():
    """Per-element clocks, one of them past the cache end (clamped, as
    JAX's dynamic_update_slice clamps)."""
    rng = np.random.RandomState(3)
    cache = rng.randn(3, 10, 2, 4).astype(np.float32)
    row = rng.randn(3, 2, 4).astype(np.float32)
    t = np.array([0, 7, 12], np.int32)
    want = jax_write_row_pe(jnp.asarray(cache), jnp.asarray(row),
                            jnp.asarray(t), 'khd', impl='dus')
    got = torch.from_numpy(cache.copy())
    out = tattn.write_row_pe(got, torch.from_numpy(row), torch.from_numpy(t).long())
    assert out is got
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for layout in ('dk', 'hkd'):
        with pytest.raises(ValueError, match="'khd'"):
            tattn.write_row_pe(got, torch.from_numpy(row), torch.zeros(3).long(),
                               layout)


def test_batchpos_decode_matches_jax():
    """24 steps with per-element clocks; an element whose step is rejected
    keeps its clock and overwrites the same cache slot with its next token,
    as the batched generator does.  Logits every step and the caches at
    the end agree."""
    jm, params, tm = gpt2_pair(V, seed=2)
    B, K = 3, 40
    rng = np.random.RandomState(2)
    jc = jm.apply(params, B, K, method=JaxGPT2.init_decode_cache)
    tc = tm.init_decode_cache(B, K)
    t = np.array([0, 5, 11], np.int32)
    rejected = 0
    for _ in range(24):
        tok, seg = (a[:, 0] for a in _tokens(rng, B, 1))
        want, jc = jm.apply(params, jnp.asarray(tok), jnp.asarray(seg),
                            jnp.asarray(t), jc,
                            method=JaxGPT2.decode_step_batchpos)
        with torch.no_grad():
            got, _ = tm.decode_step_batchpos(torch.from_numpy(tok).long(),
                                             torch.from_numpy(seg).long(),
                                             torch.from_numpy(t).long(), tc)
        _close(got, want)
        advance = rng.rand(B) > 0.25
        rejected += int((~advance).sum())
        t = t + advance
    assert rejected > 0
    _close(tc['k'], jc['k'])
    _close(tc['v'], jc['v'])
    with pytest.raises(ValueError, match="'khd'"):
        tm.init_decode_cache(B, K, 'dk')


@torch.no_grad()
def test_decode_step_matches_jax_and_the_forward():
    jm, params, tm = gpt2_pair(V, seed=4)
    tok, seg = _tokens(np.random.RandomState(4), 2, 20)
    jc = jm.apply(params, 2, 24, method=JaxGPT2.init_decode_cache)
    tc = tm.init_decode_cache(2, 24)
    steps = []
    for t in range(20):
        want, jc = jm.apply(params, jnp.asarray(tok[:, t]), jnp.asarray(seg[:, t]),
                            jnp.int32(t), jc, method=JaxGPT2.decode_step)
        got, _ = tm.decode_step(torch.from_numpy(tok[:, t]).long(),
                                torch.from_numpy(seg[:, t]).long(), t, tc)
        _close(got, want)
        steps.append(got)
    full = tm(torch.from_numpy(tok).long(), torch.from_numpy(seg).long())
    _close(torch.stack(steps, 1), full)


def test_gradients_match_jax_through_the_bridge():
    """The loss and every parameter's gradient against jax.grad of the flax
    loss, the JAX gradient tree mapped by flax_gpt2_to_torch."""
    jm, params, tm = gpt2_pair(V, seed=5)
    rng = np.random.RandomState(5)
    tok, seg = _tokens(rng, 2, 24)
    tgt = rng.randint(0, V, (2, 24)).astype(np.int32)
    tgt[rng.rand(2, 24) < 0.3] = V - 1

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(tok), jnp.asarray(seg))
        return jm.apply(p, logits, jnp.asarray(tgt), method=JaxGPT2.compute_loss)
    want, jg = jax.value_and_grad(jloss)(params)
    loss = tm.compute_loss(tm(torch.from_numpy(tok).long(),
                              torch.from_numpy(seg).long()),
                           torch.from_numpy(tgt).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    ref = flax_gpt2_to_torch(jax.tree.map(np.asarray, jg), GPT2_SMALL['n_layer'])
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(ref)
    for name, p in tm.named_parameters():
        _close(p.grad, ref[name], GRAD_RTOL, name)


def test_reference_checkpoint_round_trip(tmp_path):
    """flax -> the port -> a reference-named .pt -> the JAX package's own
    ``convert_gpt2_pt`` gives back the flax tree; the .pt, with the causal
    mask buffers older HF versions saved, loads strictly into a new model."""
    _, params, tm = gpt2_pair(V, seed=6)
    sd = tm.state_dict()
    n = GPT2_SMALL['n_layer']
    assert 'pe' not in sd and len(sd) == 4 + 12 * n
    assert {'token_emb.emb_lookup.weight', 'segemb.emb_lookup.weight',
            'transformer_decoder.1.ln_1.weight',
            'transformer_decoder.1.attn.c_attn.weight',
            'transformer_decoder.0.attn.c_proj.bias',
            'transformer_decoder.0.mlp.c_fc.weight',
            'transformer_decoder.1.mlp.c_proj.weight',
            'dec_out_proj.weight'} <= set(sd)
    assert sd['transformer_decoder.0.attn.c_attn.weight'].shape == (64, 192)
    for i in range(n):
        sd[f'transformer_decoder.{i}.attn.bias'] = torch.ones(1, 1, 8, 8).tril()
        sd[f'transformer_decoder.{i}.attn.masked_bias'] = torch.tensor(-1e4)
    path = str(tmp_path / 'gpt2.pt')
    torch.save(sd, path)
    back = convert_gpt2_pt(path, n_layer=n)
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    want, got = flat(params), flat(back)
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(val))
    fresh = MusicGPT2(n_token=V, dropout=0.0, device='cpu', **GPT2_SMALL)
    fresh.load_state_dict(torch.load(path, weights_only=True), strict=True)
    for name, p in fresh.named_parameters():
        assert torch.equal(p, tm.state_dict()[name]), name
