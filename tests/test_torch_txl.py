"""The stage-1 Transformer-XL of the PyTorch port (CPU) against the JAX
package: the relative shift, the positional embedding, the forward with and
without XL memories, the memory update, the three decode attentions and the
model's decode paths, on numpy-seeded weights carried over by
``flax_txl_to_torch``; and the sampler's per-row settings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.models.embeddings import (
    txl_positional_embedding as jax_txl_pe)
from emo_disentanger_tpu.models.txl import (
    PlainTransformer as JaxTXL, _rel_shift as jax_rel_shift,
    update_mems_varlen as jax_update_mems)
from emo_disentanger_tpu.ops import attention as jax_attn
from emo_disentanger_tpu_torch.convert import flax_txl_to_torch
from emo_disentanger_tpu_torch.models.embeddings import txl_positional_embedding
from emo_disentanger_tpu_torch.models.txl import (
    PlainTransformer, _rel_shift, update_mems_varlen)
from emo_disentanger_tpu_torch.ops import attention as attn
from emo_disentanger_tpu_torch.ops.sampling import nucleus_sample
from torch_port_helpers import fill_params, one_torch_thread  # noqa: F401

TXL_SMALL = dict(n_layer=2, n_head=4, d_model=64, d_ff=128, d_embed=64)
V = 40
# the forward's and the decode attentions' f32 tolerances against JAX
FWD_TOL, ATTN_TOL = 2e-5, 1e-5
# the port's decode against its own forward
DECODE_TOL = 1e-4


def txl_pair(vocab_size, *, seed=0, std=0.05, mem_len=0, bias_fn=None):
    """(jax_model, jax_params, torch_model) of the stage-1 TXL with the same
    numpy-drawn weights (``TXL_SMALL``), dropout 0, the torch model in eval
    mode.  ``bias_fn`` may edit the vocabulary head's bias (numpy [V])."""
    jm = JaxTXL(vocab_size=vocab_size, dropout=0.0, mem_len=mem_len,
                **TXL_SMALL)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    params = jax.tree.map(np.array, fill_params(params, seed, std))
    if bias_fn is not None:
        bias_fn(params['params']['out_proj']['bias'])
    tm = PlainTransformer(vocab_size, dropout=0.0, mem_len=mem_len,
                          device='cpu', **TXL_SMALL)
    tm.load_state_dict(flax_txl_to_torch(params, TXL_SMALL['n_layer']))
    return jm, jax.tree.map(jnp.asarray, params), tm.eval()


def _np(t):
    return t.detach().cpu().numpy()


def test_rel_shift_exact():
    x = np.random.RandomState(0).randn(2, 3, 5, 9).astype(np.float32)
    np.testing.assert_array_equal(_np(_rel_shift(torch.from_numpy(x))),
                                  np.asarray(jax_rel_shift(jnp.asarray(x))))


def test_txl_positional_embedding():
    pos = np.arange(37, -1, -1)
    got = txl_positional_embedding(torch.from_numpy(pos), 64)
    want = jax_txl_pe(jnp.asarray(pos), 64)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-6)


@pytest.mark.parametrize('case', ['plain', 'mems', 'hiddens'])
def test_forward_matches_jax(case):
    jm, params, tm = txl_pair(V, mem_len=8 if case != 'plain' else 0)
    rng = np.random.RandomState(1)
    tok = rng.randint(0, V, (2, 12)).astype(np.int32)
    tok[1, -3:] = V - 1                                   # PAD rows embed to 0
    mems_np = None
    if case != 'plain':
        mems_np = [rng.randn(2, 8, 64).astype(np.float32) for _ in range(3)]
    jmems = None if mems_np is None else [jnp.asarray(m) for m in mems_np]
    tmems = None if mems_np is None else [torch.from_numpy(m) for m in mems_np]
    hid = case == 'hiddens'
    jout = jm.apply(params, jnp.asarray(tok), jmems, return_hiddens=hid)
    with torch.no_grad():
        tout = tm(torch.from_numpy(tok).long(), tmems, return_hiddens=hid)
    np.testing.assert_allclose(_np(tout[0]), np.asarray(jout[0]), rtol=0,
                               atol=FWD_TOL)
    if case != 'plain':
        for a, b in zip(tout[1], jout[1]):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=FWD_TOL)
    else:
        assert tout[1] is None and jout[1] is None
    if hid:
        assert len(tout[2]) == len(jout[2]) == 3
        for a, b in zip(tout[2], jout[2]):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=FWD_TOL)


def test_update_mems_varlen_exact():
    rng = np.random.RandomState(2)
    mems = rng.randn(4, 6, 8).astype(np.float32)
    hids = rng.randn(4, 5, 8).astype(np.float32)
    seg = np.asarray([0, 3, 5, 9], np.int32)              # 9 clips to L=5
    got = update_mems_varlen(torch.from_numpy(mems), torch.from_numpy(hids),
                             torch.from_numpy(seg))
    want = jax_update_mems(jnp.asarray(mems), jnp.asarray(hids),
                           jnp.asarray(seg))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _attn_inputs(B=3, Kmax=64, H=4, Dh=16, R=None, seed=3):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return (f(B, H, Dh), f(B, Kmax, H, Dh), f(B, Kmax, H, Dh),
            f(B, H, Dh), f(R or Kmax, H, Dh))


@pytest.mark.parametrize('chunk', [16, 256])
@pytest.mark.parametrize('t', [0, 15, 16, 63])
def test_decode_attention_matches_jax(t, chunk):
    """Flash (chunks of 16, or one chunk of Kmax) and whole-cache decode
    attention at the chunk edges, against JAX's."""
    q, k, v, rrq, r = _attn_inputs()
    scale = 0.25
    jrel = (jnp.asarray(rrq), jnp.asarray(r))
    trel = (torch.from_numpy(rrq), torch.from_numpy(r))
    want_flash = jax_attn.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(t),
        scale=scale, chunk=chunk, rel=jrel)
    got_flash = attn.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), t,
        scale=scale, chunk=chunk, rel=trel)
    np.testing.assert_allclose(_np(got_flash), np.asarray(want_flash),
                               rtol=0, atol=ATTN_TOL)
    want_full = jax_attn.full_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(t),
        scale=scale, rel=jrel)
    got_full = attn.full_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), t,
        scale=scale, rel=trel)
    np.testing.assert_allclose(_np(got_full), np.asarray(want_full),
                               rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize('rel_impl', ['slice', 'gather'])
def test_decode_attention_pe_matches_jax(rel_impl):
    """Per-element clocks, non-uniform, with more distance rows than cache
    positions, against both of JAX's forms of the relative term."""
    q, k, v, rrq, r = _attn_inputs(B=4, R=80)
    t = np.asarray([0, 15, 40, 63], np.int32)
    want = jax_attn.full_decode_attention_pe(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(t),
        scale=0.25, rel=(jnp.asarray(rrq), jnp.asarray(r)), rel_impl=rel_impl)
    got = attn.full_decode_attention_pe(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(t).long(), scale=0.25,
        rel=(torch.from_numpy(rrq), torch.from_numpy(r)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=ATTN_TOL)


def test_decode_attention_pe_needs_distance_rows():
    q, k, v, rrq, r = _attn_inputs(R=32)
    with pytest.raises(ValueError, match='distance rows'):
        attn.full_decode_attention_pe(
            *(torch.from_numpy(a) for a in (q, k, v)),
            torch.zeros(3, dtype=torch.long), scale=1.0,
            rel=(torch.from_numpy(rrq), torch.from_numpy(r)))


@pytest.mark.parametrize('t', [20, 59])
def test_flash_cuts_the_last_chunk_at_the_cache_end(t):
    """Kmax=60 with chunks of 16: the last chunk holds 12 positions, and
    the chunked attention still equals the whole-cache one."""
    q, k, v, rrq, r = (torch.from_numpy(a) for a in _attn_inputs(Kmax=60))
    got = attn.flash_decode_attention(q, k, v, t, scale=0.25, chunk=16,
                                      rel=(rrq, r))
    want = attn.full_decode_attention(q, k, v, t, scale=0.25, rel=(rrq, r))
    torch.testing.assert_close(got, want, rtol=0, atol=ATTN_TOL)


def _tokens(n=20, B=2, seed=4):
    return np.random.RandomState(seed).randint(0, V - 1, (B, n)).astype(np.int32)


@pytest.mark.parametrize('path', ['flash', 'full', 'pe'])
def test_decode_reproduces_forward(path):
    """The port's three decode paths step for step against its own forward;
    the flash path over two chunks of 16."""
    _, _, tm = txl_pair(V)
    tok = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        ref, _ = tm(tok)
        cache = tm.init_decode_cache(2, 32)
        steps = []
        for i in range(tok.shape[1]):
            if path == 'pe':
                lg, _ = tm.decode_step_pe(tok[:, i], torch.full((2,), i), cache)
            elif path == 'full':
                lg, _ = tm.decode_step(tok[:, i], i, cache, full_attention=True)
            else:
                lg, _ = tm.decode_step(tok[:, i], i, cache, full_attention=False)
            steps.append(lg)
    torch.testing.assert_close(torch.stack(steps, 1), ref, rtol=0,
                               atol=DECODE_TOL)


def test_decode_step_matches_jax():
    """Both frameworks' decode_step (auto-selected attention at B=2, the
    chunked one) over the same tokens."""
    jm, params, tm = txl_pair(V)
    tok = _tokens(n=10)
    jcache = jm.apply(params, 2, 16, method=JaxTXL.init_decode_cache)
    tcache = tm.init_decode_cache(2, 16)
    for i in range(tok.shape[1]):
        jl, jcache = jm.apply(params, jnp.asarray(tok[:, i]), jnp.int32(i),
                              jcache, method=JaxTXL.decode_step)
        with torch.no_grad():
            tl, _ = tm.decode_step(torch.from_numpy(tok[:, i]).long(), i, tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=FWD_TOL)


def test_decode_step_pe_uniform_is_the_full_step_bitwise():
    _, _, tm = txl_pair(V)
    tok = torch.from_numpy(_tokens(n=12)).long()
    a, b = tm.init_decode_cache(2, 16), tm.init_decode_cache(2, 16)
    with torch.no_grad():
        for i in range(tok.shape[1]):
            la, _ = tm.decode_step(tok[:, i], i, a, full_attention=True)
            lb, _ = tm.decode_step_pe(tok[:, i], torch.full((2,), i), b)
            assert torch.equal(la, lb), i
    assert torch.equal(a['k'], b['k']) and torch.equal(a['v'], b['v'])


def test_nucleus_per_row_settings_equal_the_float_calls():
    """Per-row temperature and top_p tensors give, row for row, the draw of
    the float call with that row's settings on the same generator state."""
    logits = torch.from_numpy(
        np.random.RandomState(5).randn(6, 30).astype(np.float32))
    key = torch.tensor([True, False, True, False, False, True])
    temp = torch.where(key, 1.1, 1.2)
    top_p = torch.where(key, 0.97, 0.9)
    for seed in range(20):
        got = nucleus_sample(logits, temp, top_p,
                             torch.Generator().manual_seed(seed))
        a = nucleus_sample(logits, 1.1, 0.97, torch.Generator().manual_seed(seed))
        b = nucleus_sample(logits, 1.2, 0.9, torch.Generator().manual_seed(seed))
        assert got.tolist() == torch.where(key, a, b).tolist()
