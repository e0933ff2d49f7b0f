"""Widths off the kernels' tiles: the port (CPU) against the JAX package, and
the wrappers' padding against the plain versions at the true widths.

* The Performer at D = 120, 3 heads (Dh = 40), M = 36, d_ff 200, two
  layers: forward logits and every parameter's gradient against JAX's with
  its Pallas kernels in interpret mode (``EMODIS_PALLAS_INTERPRET=1``), and
  the batch-position decode against JAX's in both state layouts (JAX's
  fused decode kernel, interpret mode, carries 'md'; its composed path
  'dm').  Tolerances: logits rtol 2e-4 / atol 1e-4 (``test_torch_performer.py``),
  gradients 2e-3 of the largest reference magnitude (the JAX suite's
  gradient tolerance).
* GPT-2 at d_model 256 with 2 heads (Dh = 128): logits and per-layer k, v
  within 1e-5 of the largest magnitude, and greedy streams of ``generate``
  token for token, each sampled row's top-2 gap above ten times the 2e-5
  logit bound (``test_torch_gpt2_serve.py``).
* The padded launches (``_kmax_padded``, ``_fwd_padded``, ``_bwd_a_padded``,
  ``_bwd_b_padded``, ``_flash_attention_padded``) with the plain versions in
  the kernels' place: pad to the tile, the plain version told the true Dh
  and M (masked feature columns, the query max and 1/sqrt(M) over the true
  M), unpad; against the plain version at the true widths, within 1e-5 of
  the largest magnitude in f32 and 1e-2 in bf16 (one bf16 rounding of a
  sum taken in another order).  Without the mask the padded features
  differ, so the mask is what makes the padding exact.
* The CUDA launches with a fake library: the tile widths, the true Dh and M
  and the workspace they pass, and the true widths they return.
"""

import collections
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.infer.stage2_batch import (
    Stage2BatchGenerator as JaxGenerator)
from emo_disentanger_tpu.models.performer import MusicPerformer as JaxPerformer
from emo_disentanger_tpu_torch.convert import flax_performer_to_torch
from emo_disentanger_tpu_torch.infer import stage2_batch as ts2b
from emo_disentanger_tpu_torch.models import MusicPerformer as TorchPerformer
from emo_disentanger_tpu_torch.ops import _build
from emo_disentanger_tpu_torch.ops import flash_attention as fa
from emo_disentanger_tpu_torch.ops import linear_attention as la
from tests_vocab_helper import tiny_vocab2
from torch_port_helpers import fill_params, gpt2_pair, one_torch_thread  # noqa: F401
import test_torch_gpt2_serve as gs

V = 40
RTOL, ATOL = 2e-4, 1e-4
GRAD_RTOL = 2e-3
TOL_F32, TOL_BF16 = 1e-5, 1e-2
ODD = dict(n_layer=2, n_head=3, d_model=120, d_ff=200, d_embed=120,
           favor_dims=36)


def _rel(got, want, tol, what=''):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(torch.as_tensor(want).float() if isinstance(want, torch.Tensor)
                      else want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _performer_pair(seed):
    jm = JaxPerformer(n_token=V, dropout=0.0, **ODD)
    jom = jm.draw_omegas(jax.random.PRNGKey(1))
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32), jom,
                     jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.array, fill_params(params, seed, 0.05))
    tm = TorchPerformer(n_token=V, dropout=0.0, device='cpu', **ODD)
    tm.load_state_dict(flax_performer_to_torch(params, ODD['n_layer']))
    return (jm, jax.tree.map(jnp.asarray, params), jom, tm.eval(),
            torch.from_numpy(np.array(jom)))


def _tokens(rng, B, L):
    return (rng.randint(0, V - 1, (B, L)).astype(np.int32),
            rng.randint(0, 2, (B, L)).astype(np.int32))


def test_performer_forward_and_gradients_at_odd_widths(monkeypatch):
    """Dh 40, M 36: JAX's fused FAVOR+ kernels (interpret mode) against the
    port's plain versions, logits and the gradient of the loss."""
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1')
    jm, params, jom, tm, tom = _performer_pair(seed=3)
    rng = np.random.RandomState(3)
    tok, seg = _tokens(rng, 2, 70)
    tgt = rng.randint(0, V, (2, 70)).astype(np.int32)

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(tok), jom, jnp.asarray(seg))
        return jm.apply(p, logits, jnp.asarray(tgt),
                        method=JaxPerformer.compute_loss), logits
    (want, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    logits = tm(torch.from_numpy(tok).long(), tom, torch.from_numpy(seg).long())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    loss = tm.compute_loss(logits, torch.from_numpy(tgt).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    ref = flax_performer_to_torch(jax.tree.map(np.asarray, jg), ODD['n_layer'])
    for name, p in tm.named_parameters():
        _rel(p.grad, ref[name], GRAD_RTOL, name)


@pytest.mark.parametrize('layout', ['dm', 'md'])
def test_performer_decode_at_odd_widths(layout, monkeypatch):
    """12 masked per-element steps at Dh 40, M 36 against JAX's decode in
    the same layout ('md': JAX's fused decode kernel in interpret mode),
    logits and the carried state."""
    if layout == 'md':
        monkeypatch.setenv('EMODIS_FUSED_DECODE', '1')
    jm, params, jom, tm, tom = _performer_pair(seed=4)
    B, steps = 3, 12
    rng = np.random.RandomState(4)
    jstate = jm.apply(params, B, layout, method=JaxPerformer.init_decode_state)
    tstate = tm.init_decode_state(B, layout)
    t = np.array([0, 3, 7], np.int32)
    for i in range(steps):
        tok = rng.randint(0, V - 1, B).astype(np.int32)
        seg = rng.randint(0, 2, B).astype(np.int32)
        mask = np.array([True, i % 2 == 0, rng.rand() > 0.3])
        want, jstate = jm.apply(params, jnp.asarray(tok), jnp.asarray(seg),
                                jnp.asarray(t), jom, jstate,
                                update_mask=jnp.asarray(mask), state_layout=layout,
                                method=JaxPerformer.decode_step_batchpos)
        with torch.no_grad():
            got, tstate = tm.decode_step_batchpos(
                torch.from_numpy(tok).long(), torch.from_numpy(seg).long(),
                torch.from_numpy(t).long(), tom, tstate,
                update_mask=torch.from_numpy(mask), state_layout=layout)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        t = t + mask
    for name in ('S', 'z'):
        assert tuple(tstate[name].shape) == jstate[name].shape
        np.testing.assert_allclose(tstate[name].numpy(), np.asarray(jstate[name]),
                                   rtol=RTOL, atol=ATOL)


GPT2_WIDE = dict(n_head=2, d_model=256, d_ff=128, d_embed=256)


def test_gpt2_values_at_head_width_128():
    """Logits and every layer's k, v at Dh 128 (d_model 256, 2 heads)."""
    jm, params, tm = gpt2_pair(V, seed=6, **GPT2_WIDE)
    tok, seg = _tokens(np.random.RandomState(6), 2, 48)
    want, jk, jv = jm.apply(params, jnp.asarray(tok), jnp.asarray(seg),
                            return_kv=True)
    with torch.no_grad():
        got, tk, tv = tm(torch.from_numpy(tok).long(),
                         torch.from_numpy(seg).long(), return_kv=True)
    _rel(got, want, TOL_F32, 'logits')
    _rel(tk, jk, TOL_F32, 'k')
    _rel(tv, jv, TOL_F32, 'v')


def test_gpt2_greedy_streams_at_head_width_128(monkeypatch):
    """``generate`` at top_p 0 through the window re-anchors, token for token
    against JAX's, each sampled row's top-2 gap checked."""
    jv = tiny_vocab2()
    beats = [jv.event2idx[f'Beat_{b}'] for b in range(16)]

    def bias(b):
        b[jv.pad_id] = b[jv.event2idx['EOS_None']] = -30.0
        b[beats] -= 0.5
        b[jv.event2idx['Track_LeadSheet']] += 0.5
    # weights at std 0.03, so that songs run to max_events past the cache
    jm, params, tm = gpt2_pair(jv.size, seed=13, std=0.03, bias_fn=bias,
                               **GPT2_WIDE)
    primers, sheets = gs._jobs(jv, 3, np.random.RandomState(0))
    gaps = gs.SampledGaps(monkeypatch)
    kw = gs.KW
    tres = ts2b.Stage2BatchGenerator(tm, gs._port_vocab(jv), batch=3, device='cpu',
                                     **kw).generate(primers, sheets, seed=11)
    jres = JaxGenerator(jm, params, jv, batch=3, **kw).generate(
        primers, sheets, seed=3)
    assert tres[0] == jres[0]
    for key in ('status', 'bars', 'events', 'reanchors'):
        assert tres[1][key] == jres[1][key], key
    assert sum(tres[1]['reanchors']) >= 1
    assert gaps.check(batched=True) > 200
    gs._replay_agrees(jm, params, tm, jv, tres[0])


# ----------------------------------------------------- the padded launches

def _favor_inputs(layout, B, H, L, Dh, M, dtype, seed=0):
    """q, k, v, g [B*H, L, Dh] (head-major) or [B, L, H*Dh], omega [Dh, M]."""
    rng = np.random.RandomState(seed)
    shape = (B * H, L, Dh) if layout == 'head-major' else (B, L, H * Dh)
    q, k, v, g = (torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.7)
                  .to(dtype) for _ in range(4))
    omega = torch.from_numpy(rng.randn(Dh, M).astype(np.float32))
    return q, k, v, g, omega


def _split(layout, H):
    if layout == 'head-major':
        return (lambda t: t), (lambda t, B: t), None
    return (lambda t: la._split_heads(t, H)), la._merge_heads, H


def _plain_launches(layout, H):
    """The plain versions with the kernels' launch signatures (tile widths,
    then the true Dh and M), in the given layout."""
    sp, mg, _ = _split(layout, H)
    B = lambda t: t.shape[0]
    dt = la._dot_dtype_for

    def kmax(k, omega, Dh, M):
        return la._key_max_plain(sp(k), omega, Dh, M)[:, None]

    def fwd(q, k, v, omega, partial, eps, Dh, M):
        out = la._favor_compose(sp(q), sp(k), sp(v), omega, la.CHUNK, eps,
                                partial.amax(1), Dh, M)
        return mg(out, B(q)).to(q.dtype)

    def bwd_a(q, k, v, g, omega, partial, eps, Dh, M):
        dq, u, w = la._favor_bwd_a_plain(sp(q), sp(k), sp(v), sp(g), omega,
                                         partial.amax(1), la.CHUNK, eps, dt(q),
                                         Dh, M)
        return mg(dq, B(q)).to(q.dtype), mg(u, B(q)), w

    def bwd_b(q, k, v, u, w, omega, partial, Dh, M):
        dk, dv = la._favor_bwd_b_plain(sp(q), sp(k), sp(v), sp(u), w, omega,
                                       partial.amax(1), la.CHUNK, dt(q), Dh, M)
        return mg(dk, B(q)).to(q.dtype), mg(dv, B(q)).to(q.dtype)
    return kmax, fwd, bwd_a, bwd_b


# (Dh, M): the JAX test's bf16 shape, widths off both tiles, an odd one
PAD_WIDTHS = [(8, 16), (40, 36), (6, 5), (20, 100)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('layout', ['head-major', 'heads-last'])
@pytest.mark.parametrize('widths', PAD_WIDTHS, ids=lambda w: f'Dh{w[0]}-M{w[1]}')
def test_padded_launches_equal_the_plain_versions(widths, layout, dtype):
    """Key max, forward and both passes through the padded launches equal
    the plain versions at the true widths, L = 77 (a ragged chunk)."""
    Dh, M = widths
    H = 2
    q, k, v, g, omega = _favor_inputs(layout, 2, H, 77, Dh, M, dtype)
    kmax_l, fwd_l, bwd_a_l, bwd_b_l = _plain_launches(layout, H)
    sp, mg, n_head = _split(layout, H)
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    want_kmax = la._key_max_plain(sp(k), omega)
    partial = la._kmax_padded(kmax_l, k, omega, n_head)
    _rel(partial[:, 0], want_kmax, TOL_F32, 'kmax')

    out = la._fwd_padded(fwd_l, q, k, v, omega, partial, la.EPS, n_head)
    want = mg(la._favor_compose(sp(q), sp(k), sp(v), omega, la.CHUNK, la.EPS,
                                want_kmax), q.shape[0]).to(dtype)
    assert out.shape == q.shape and out.dtype == dtype
    _rel(out, want, tol, 'out')

    dq, u, w = la._bwd_a_padded(bwd_a_l, q, k, v, g, omega, partial, la.EPS, n_head)
    wdq, wu, ww = la._favor_bwd_a_plain(sp(q), sp(k), sp(v), sp(g), omega,
                                        want_kmax, la.CHUNK, la.EPS,
                                        la._dot_dtype_for(q))
    _rel(dq, mg(wdq, q.shape[0]), tol, 'dq')
    _rel(u, mg(wu, q.shape[0]), tol, 'u')
    _rel(w, ww, tol, 'w')

    dk, dv = la._bwd_b_padded(bwd_b_l, q, k, v, u, w, omega, partial, n_head)
    wdk, wdv = la._favor_bwd_b_plain(sp(q), sp(k), sp(v), sp(u), w, omega,
                                     want_kmax, la.CHUNK, la._dot_dtype_for(q))
    _rel(dk, mg(wdk, q.shape[0]), tol, 'dk')
    _rel(dv, mg(wdv, q.shape[0]), tol, 'dv')


def test_padded_features_need_the_mask():
    """Zero-padded omega columns alone give features exp(-|x|^2/2 - max) /
    sqrt(M) != 0 and change the query max and 1/sqrt(M); told the true M,
    the padded features are the true ones followed by zeros."""
    q, _, _, _, omega = _favor_inputs('head-major', 1, 2, 30, 40, 36,
                                      torch.float32)
    qp, omp = la._pad_cols(q, 48), la._pad_omega(omega, 48, 48)
    true = la.favor_features(q, omega, is_query=True)
    masked = la.favor_features(qp, omp, is_query=True, d_head=40, n_features=36)
    _rel(masked[..., :36], true, TOL_F32, 'masked features')
    assert torch.equal(masked[..., 36:], torch.zeros_like(masked[..., 36:]))
    unmasked = la.favor_features(qp, omp, is_query=True, d_head=40)
    assert float(unmasked[..., 36:].min()) > 0
    assert not torch.allclose(unmasked[..., :36], true, rtol=1e-3)
    keys = la.favor_features(qp, omp, is_query=False, d_head=40, n_features=36)
    _rel(keys[..., :36], la.favor_features(q, omega, is_query=False), TOL_F32, 'keys')
    assert la._key_max_plain(qp, omp, 40, 36).allclose(la._key_max_plain(q, omega))


@pytest.mark.parametrize('Dh', [20, 40, 96, 200])
def test_flash_padding_equals_the_plain_version(Dh):
    """Zero columns to the next head tile change no score and no kept output
    value: pad, the plain version, unpad against the plain version."""
    rng = np.random.RandomState(Dh)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 128, Dh).astype(np.float32))
               for _ in range(3))
    scale = Dh ** -0.5
    got = fa._flash_attention_padded(q, k, v, scale, fa._flash_attention_plain)
    _rel(got, fa._flash_attention_plain(q, k, v, scale), TOL_F32)
    assert got.shape == q.shape and got.is_contiguous()


# -------------------------------------------- the launches, library faked

@pytest.fixture
def fake_libs(monkeypatch):
    """Every FAVOR+ and flash library call recorded, returning 0; the device
    check and the stream faked; launch counts restored after."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0
    for mod, fn in ((la, '_lib'), (la, '_bwd_lib'), (fa, '_lib')):
        monkeypatch.setattr(mod, fn, Lib)
    monkeypatch.setattr(la, '_require_cuda', lambda device: None)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, 'LAUNCHES', collections.Counter())
    return calls


@pytest.mark.parametrize('layout', ['head-major', 'heads-last'])
def test_launches_pad_to_the_tile(fake_libs, layout):
    """bf16 Dh 40, M 36 reach the kernels as 48, 48, 48 with Dt 40, Mt 36 and
    no workspace; the results come back at Dh 40."""
    H = 2
    q, k, v, g, omega = _favor_inputs(layout, 2, H, 80, 40, 36, torch.bfloat16)
    hl = layout == 'heads-last'
    extra = (H,) if hl else ()
    sfx = '_hl' if hl else ''
    partial = getattr(la, f'_favor_kmax{sfx}_cuda')(k, omega, *extra)
    out = getattr(la, f'_favor_fwd{sfx}_cuda')(q, k, v, omega, partial, *extra)
    dq, u, w = getattr(la, f'_favor_bwd_a{sfx}_cuda')(q, k, v, g, omega, partial,
                                                       *extra)
    dk, dv = getattr(la, f'_favor_bwd_b{sfx}_cuda')(q, k, v, u, w, omega, partial,
                                                    *extra)
    assert [n for n, _ in fake_libs] == [f'favor_{n}{sfx}' for n in
                                         ('kmax', 'fwd', 'bwd_a', 'bwd_b')]
    for name, args in fake_libs:
        assert args[-5:-1] == (40, 36, None, 0), name     # Dt, Mt, no workspace
    widths = {'favor_kmax': (5, 7), 'favor_fwd': (8, 11), 'favor_bwd_a': (11, 14),
              'favor_bwd_b': (11, 14), 'favor_kmax_hl': (6, 8),
              'favor_fwd_hl': (9, 11), 'favor_bwd_a_hl': (12, 14),
              'favor_bwd_b_hl': (12, 14)}
    for name, args in fake_libs:
        lo, hi = widths[name]
        assert set(args[lo:hi]) == {48}, (name, args[lo:hi])
    assert all(t.shape == q.shape for t in (out, dq, dk, u, dv))
    assert w.shape == (4, 80) and partial.shape == (4, 2)
    assert dict(_build.LAUNCHES) == {name: 1 for name, _ in fake_libs}


def test_wide_launches_take_a_workspace(fake_libs):
    """At Dh = Dv = 128, M = 256 under bf16 a block's tiles exceed shared
    memory: each launch gets a workspace of a row's tiles for every row."""
    q, k, v, g, omega = _favor_inputs('head-major', 1, 2, 64, 128, 256,
                                      torch.bfloat16)
    partial = la._favor_kmax_cuda(k, omega)
    la._favor_fwd_cuda(q, k, v, omega, partial)
    la._favor_bwd_a_cuda(q, k, v, g, omega, partial)
    kinds = ('kmax', 'fwd', 'bwd_a')
    for (name, args), kind in zip(fake_libs, kinds):
        floats = la._tile_floats(kind, 128, 128, 256, True)
        if kind == 'kmax':            # omega and the rows fit: 165 KB
            assert 4 * floats <= la.SMEM_MAX and args[-3:-1] == (None, 0)
        else:
            assert 4 * floats > la.SMEM_MAX
            assert args[-3] is not None and args[-2] == 2 * floats, name
    assert la._favor_workspace('fwd', 16, 64, 64, 128, torch.bfloat16, 'cpu')[:2] == (None, 0)


@pytest.mark.parametrize('Dh', [40, 128])
def test_flash_launch_pads_to_the_tile(fake_libs, Dh):
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 128, Dh).astype(np.float32))
               for _ in range(3))
    """The launch on the padded tensors gets the head tile as Dh and the
    result comes back at the true Dh."""
    out = fa._flash_attention_padded(q, k, v, 0.1, fa._launch)
    (name, args), = fake_libs
    assert name == 'flash_attn_fwd' and args[6] == fa.head_tile(Dh)
    assert out.shape == q.shape
    assert _build.LAUNCHES == {'flash_attention_fwd': 1}


@pytest.mark.parametrize('widths', [(34, 18), (5, 3), (36, 20)],
                         ids=lambda w: f'M{w[0]}-Dv{w[1]}')
def test_composed_op_padding_equals_the_plain_passes(widths):
    """``_cla_padded``: M and Dv padded to the kernels' multiple of 4, the
    plain forward and both plain passes on the padded tensors, the true
    columns taken: equal to the plain versions at the true widths."""
    M, Dv = widths
    rng = np.random.RandomState(M)
    q, k = (torch.from_numpy(rng.rand(3, 70, M).astype(np.float32)) for _ in range(2))
    v, g = (torch.from_numpy(rng.randn(3, 70, Dv).astype(np.float32)) for _ in range(2))
    (qp, kp, vp, gp), m, dv_ = la._cla_padded(q, k, v, g)
    assert (m, dv_) == (M, Dv) and qp.shape[-1] % 4 == 0 and vp.shape[-1] % 4 == 0
    out = la._unpad_cols(la._cla_fwd_plain(qp, kp, vp), Dv)
    _rel(out, la._cla_fwd_plain(q, k, v), TOL_F32, 'out')
    dq, u, w = la._cla_bwd_a_plain(qp, kp, vp, gp)
    rdq, ru, rw = la._cla_bwd_a_plain(q, k, v, g)
    _rel(la._unpad_cols(dq, M), rdq, TOL_F32, 'dphi_q')
    _rel(w, rw, TOL_F32, 'w')
    dk, dv = la._cla_bwd_b_plain(qp, kp, vp, u, w)
    rdk, rdv = la._cla_bwd_b_plain(q, k, v, ru, rw)
    _rel(la._unpad_cols(dk, M), rdk, TOL_F32, 'dphi_k')
    _rel(la._unpad_cols(dv, Dv), rdv, TOL_F32, 'dv')


def test_composed_op_launches_pad_to_four(monkeypatch):
    """M 34, Dv 18 reach the composed op's three kernels as 36 and 20, and
    the results come back at 34 and 18."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0
    monkeypatch.setattr(la, '_cla_lib', Lib)
    monkeypatch.setattr(la, '_require_cuda', lambda device: None)
    monkeypatch.setattr(_build, 'LAUNCHES', collections.Counter())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    rng = np.random.RandomState(0)
    q, k = (torch.from_numpy(rng.rand(3, 70, 34).astype(np.float32)) for _ in range(2))
    v, g = (torch.from_numpy(rng.randn(3, 70, 18).astype(np.float32)) for _ in range(2))
    out = la._cla_fwd_aligned_cuda(q, k, v)
    dq, dk, dv = la._cla_bwd_cuda(q, k, v, g)
    assert [n for n, _ in calls] == ['cla_fwd', 'cla_bwd_a', 'cla_bwd_b']
    assert calls[0][1][4:8] == (3, 70, 36, 20)
    assert all(args[7:11] == (3, 70, 36, 20) for _, args in calls[1:])
    assert out.shape == v.shape and dq.shape == q.shape and dk.shape == k.shape
    assert dv.shape == v.shape
