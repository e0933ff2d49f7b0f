"""The port's ``causal_linear_attention`` (plain PyTorch versions, CPU)
against the JAX package's: its chunked scan and the autodiff of it
(``EMODIS_PALLAS_INTERPRET=0``), and its Pallas kernels ``_pallas_kernel``,
``_bwd_a_kernel`` and ``_bwd_b_kernel`` in interpret mode (``=1``).  Also the
composed FAVOR+ path against the fused op, and the CUDA wrappers' refusal of
CPU tensors.

Tolerances, relative to the largest reference magnitude: the float32
forward 1e-5 and the float32 gradients 1e-4 (both sides compute the same
chunked recurrence in float32, in other summation orders).  bf16 gradients
are float32 gradients rounded to bf16 on both sides: two roundings of at
most half a bf16 ulp (2^-9 relative) each, so 2^-8 on top of 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.ops import linear_attention as jla
from emo_disentanger_tpu_torch.ops import causal_linear_attention
from emo_disentanger_tpu_torch.ops import linear_attention as tla

TOL_OUT = 1e-5
TOL_GRAD = 1e-4
TOL_BF16_GRAD = 2.0 ** -8 + 1e-4

B, H, M, DV, CHUNK = 2, 3, 32, 16, 16
LENGTHS = (100, 37)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _features(seed, L, b=B, h=H, m=M, dv=DV):
    """phi_q, phi_k uniform in [0.01, 1] (as tests/test_linear_attention.py
    draws them), v and a cotangent g normal; float32 numpy."""
    rng = np.random.RandomState(seed)
    pq, pk = (rng.uniform(0.01, 1.0, (b, h, L, m)).astype(np.float32)
              for _ in range(2))
    v, g = (rng.randn(b, h, L, dv).astype(np.float32) for _ in range(2))
    return pq, pk, v, g


def _port_grads(pq, pk, v, g, chunk=CHUNK, dtypes=(torch.float32,) * 3):
    leaves = [torch.from_numpy(a).to(dt).requires_grad_()
              for a, dt in zip((pq, pk, v), dtypes)]
    out = causal_linear_attention(*leaves, chunk)
    out.backward(torch.from_numpy(g))
    return out.detach(), [t.grad for t in leaves]


def _jax_grads(pq, pk, v, g, chunk=CHUNK, dtypes=(jnp.float32,) * 3):
    out, vjp = jax.vjp(lambda a, b_, c: jla.causal_linear_attention(a, b_, c, chunk),
                       *(jnp.asarray(a).astype(dt) for a, dt in zip((pq, pk, v), dtypes)))
    return out, vjp(jnp.asarray(g))


@pytest.mark.parametrize('interpret', ['0', '1'], ids=['scan', 'pallas'])
@pytest.mark.parametrize('L', LENGTHS)
def test_forward_matches_jax(L, interpret, monkeypatch):
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', interpret)
    pq, pk, v, _ = _features(L, L)
    want = jla.causal_linear_attention(*map(jnp.asarray, (pq, pk, v)), CHUNK)
    got = causal_linear_attention(*map(torch.from_numpy, (pq, pk, v)), CHUNK)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, L, DV)
    assert _rel(got.numpy(), want) <= TOL_OUT


@pytest.mark.parametrize('interpret', ['0', '1'], ids=['scan', 'pallas'])
@pytest.mark.parametrize('L', LENGTHS)
def test_gradients_match_jax_grad(L, interpret, monkeypatch):
    """The autograd Function against jax.vjp of JAX's custom_vjp: the
    autodiff of its scan, or its two Pallas backward kernels."""
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', interpret)
    pq, pk, v, g = _features(10 + L, L)
    out, grads = _port_grads(pq, pk, v, g)
    want_out, want = _jax_grads(pq, pk, v, g)
    assert _rel(out.numpy(), want_out) <= TOL_OUT
    for name, a, b in zip(('dphi_q', 'dphi_k', 'dv'), grads, want):
        assert a.dtype == torch.float32
        assert _rel(a.numpy(), b) <= TOL_GRAD, name


@pytest.mark.parametrize('L', LENGTHS)
def test_plain_passes_match_jax_kernels(L, monkeypatch):
    """Pass A's dphi_q, u and w against ``_bwd_a_kernel``'s outputs, caught
    on their way out of ``_pallas_call`` (JAX's w is [BH, L, 1], the port's
    [BH, L]); pass B, fed the port's own (u, w), against ``_bwd_b_kernel``."""
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1')
    outs = []
    real = jla._pallas_call

    def spy(*args, **kwargs):
        fn = real(*args, **kwargs)

        def call(*a):
            outs.append(fn(*a))
            return outs[-1]
        return call
    monkeypatch.setattr(jla, '_pallas_call', spy)
    pq, pk, v, g = _features(20 + L, L)
    jla._cla_bwd(CHUNK, jla.EPS, tuple(map(jnp.asarray, (pq, pk, v))),
                 jnp.asarray(g))
    (jdq, ju, jw), (jdk, jdv) = outs
    bh = B * H
    flat = lambda a: torch.from_numpy(a).reshape(bh, L, -1)
    q2, k2, v2, g2 = map(flat, (pq, pk, v, g))
    dq, u, w = tla._cla_bwd_a_plain(q2, k2, v2, g2, CHUNK)
    dk, dv = tla._cla_bwd_b_plain(q2, k2, v2, u, w, CHUNK)
    assert tuple(w.shape) == (bh, L) and tuple(jw.shape[1:]) == (L + (-L) % CHUNK, 1)
    pairs = {'dphi_q': (dq, jdq), 'u': (u, ju), 'w': (w, jw[..., 0]),
             'dphi_k': (dk, jdk), 'dv': (dv, jdv)}
    for name, (a, b) in pairs.items():
        assert a.dtype == torch.float32
        assert _rel(a.numpy(), np.asarray(b)[:, :L]) <= TOL_GRAD, name


@pytest.mark.parametrize('v_bf16_only', [False, True], ids=['all', 'v'])
def test_bf16_inputs_match_jax_kernels(v_bf16_only, monkeypatch):
    """bf16 features and v, or float32 features (``favor_features``' type)
    with bf16 v: JAX's kernels widen each input to float32, give a float32
    output and, on float32 casts, each gradient in its input's type; so
    does the port."""
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1')
    L = LENGTHS[0]
    pq, pk, v, g = _features(30, L)
    n_f32 = 2 if v_bf16_only else 0
    tdt = (torch.float32,) * n_f32 + (torch.bfloat16,) * (3 - n_f32)
    jdt = (jnp.float32,) * n_f32 + (jnp.bfloat16,) * (3 - n_f32)
    out, grads = _port_grads(pq, pk, v, g, dtypes=tdt)
    want_out, want = _jax_grads(pq, pk, v, g, dtypes=jdt)
    assert out.dtype == torch.float32 and want_out.dtype == jnp.float32
    assert _rel(out.numpy(), want_out) <= TOL_OUT
    for name, a, b, t, j in zip(('dphi_q', 'dphi_k', 'dv'), grads, want, tdt, jdt):
        assert a.dtype == t and b.dtype == j, name
        tol = TOL_GRAD if t == torch.float32 else TOL_BF16_GRAD
        assert _rel(a.float().numpy(), b.astype(jnp.float32)) <= tol, name


def test_gradcheck_float64():
    """Finite differences in float64 through the plain Function, with a
    ragged last chunk."""
    gen = torch.Generator().manual_seed(0)
    pq, pk = (0.01 + torch.rand(1, 2, 11, 4, generator=gen, dtype=torch.float64)
              for _ in range(2))
    v = torch.randn(1, 2, 11, 3, generator=gen, dtype=torch.float64)
    leaves = [t.requires_grad_() for t in (pq, pk, v)]
    assert torch.autograd.gradcheck(
        lambda a, b_, c: causal_linear_attention(a, b_, c, 4), leaves)


def test_plain_forward_matches_ref():
    """The plain forward (any chunk) against the O(L^2) masked product."""
    pq, pk, v, _ = _features(40, 37)
    t = list(map(torch.from_numpy, (pq, pk, v)))
    want = tla.causal_linear_attention_ref(*t)
    for chunk in (8, 64):
        assert _rel(causal_linear_attention(*t, chunk).numpy(), want.numpy()) <= TOL_OUT


def test_composed_path_matches_fused():
    """``causal_linear_attention(favor_features(q), favor_features(k), v)``
    against the port's fused ``favor_causal_attention`` (outputs and
    gradients to q, k, v) and against JAX's composition, in the setting of
    JAX's ``test_fused_matches_composition``: B=2, H=2, L=64, Dh=Dv=16,
    32 features of ``draw_orthogonal_features(PRNGKey(5), 16, 32)``,
    chunk 16."""
    rng = np.random.RandomState(50)
    q, k, v, g = (rng.randn(2, 2, 64, 16).astype(np.float32) for _ in range(4))
    om = np.array(jla.draw_orthogonal_features(jax.random.PRNGKey(5), 16, 32))
    tom = torch.from_numpy(om)

    def composed(q_, k_, v_):
        return causal_linear_attention(tla.favor_features(q_, tom, is_query=True),
                                       tla.favor_features(k_, tom, is_query=False),
                                       v_, 16)
    runs = []
    for fn in (composed, lambda q_, k_, v_: tla.favor_causal_attention(
            q_, k_, v_, tom, 16)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fn(*leaves)
        out.backward(torch.from_numpy(g))
        runs.append((out.detach().numpy(), [t.grad.numpy() for t in leaves]))
    (out_c, grads_c), (out_f, grads_f) = runs
    jom = jnp.asarray(om)
    want = jla.causal_linear_attention(
        jla.favor_features(jnp.asarray(q), jom, is_query=True),
        jla.favor_features(jnp.asarray(k), jom, is_query=False), jnp.asarray(v), 16)
    assert _rel(out_c, out_f) <= TOL_OUT
    assert _rel(out_c, want) <= TOL_OUT
    for name, a, b in zip(('dq', 'dk', 'dv'), grads_c, grads_f):
        assert _rel(a, b) <= TOL_GRAD, name


@pytest.mark.parametrize('name', ['cla_fwd', 'cla_bwd_a', 'cla_bwd_b'])
def test_cuda_wrappers_refuse_cpu_tensors(name):
    bh, L = 2, 8
    q, k = (torch.rand(bh, L, M) for _ in range(2))
    v, g = (torch.randn(bh, L, DV) for _ in range(2))
    calls = {'cla_fwd': lambda: tla._cla_fwd_cuda(q, k, v),
             'cla_bwd_a': lambda: tla._cla_bwd_a_cuda(q, k, v, g),
             'cla_bwd_b': lambda: tla._cla_bwd_b_cuda(q, k, v, g, g[..., 0])}
    with pytest.raises(ValueError, match='CUDA tensors'):
        calls[name]()
