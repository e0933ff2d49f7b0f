"""The port's FAVOR+ backward (plain PyTorch versions, CPU) against the JAX
package: the two plain passes against JAX's fused backward kernels
(``_fused_bwd_a_kernel`` / ``_fused_bwd_b_kernel``, interpret mode) in f32
and bf16, and the autograd ``Function`` against ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.ops import linear_attention as jla
from emo_disentanger_tpu_torch.ops import linear_attention as tla
from torch_port_helpers import ATOL, RTOL

# the JAX suite's gradient tolerance (tests/test_linear_attention.py:158-175)
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
# bf16: both sides round the same operands to bf16 and accumulate in f32;
# measured identical on these inputs, held to one bf16 ulp (2^-7 relative)
# since a float32 exp that differs in its last bit can flip a rounding
BF16_RTOL = 2.0 ** -7

BH, L, D, M, CHUNK = 4, 64, 8, 16, 32


def _randn(rng, *shape, scale=0.7):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _omega(seed, d_head=D, m=M):
    return np.array(jla.draw_orthogonal_features(
        jax.random.PRNGKey(seed), d_head, m))


@pytest.fixture
def jax_bwd(monkeypatch):
    """Run JAX's fused backward in interpret mode and return
    (dq, dk, dv, u, w): u and w unpacked from pass A's ``uw`` residual,
    caught on its way out of ``_pallas_call``."""
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

    def run(q, k, v, g, om):
        dq, dk, dv = jla._fused_bwd_impl(q, k, v, g, jnp.asarray(om), CHUNK,
                                         jla.EPS)
        uw = outs[1][1]                   # kmax, pass A (dq, uw), pass B
        return [np.asarray(t.astype(jnp.float32))
                for t in (dq, dk, dv, uw[..., :D], uw[..., D])]
    return run


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q, k, v, g = (_randn(rng, BH, L, D) for _ in range(4))
    return q, k, v, g, _omega(seed + 1)


def _plain(q, k, v, g, om, dot_dtype=None):
    kmax = tla._key_max_plain(k, om)
    dq, u, w = tla._favor_bwd_a_plain(q, k, v, g, om, kmax, CHUNK,
                                      dot_dtype=dot_dtype)
    dk, dv = tla._favor_bwd_b_plain(q, k, v, u, w, om, kmax, CHUNK,
                                    dot_dtype=dot_dtype)
    return dq, dk, dv, u, w


def test_plain_passes_match_jax_kernels_f32(jax_bwd):
    q, k, v, g, om = _inputs(0)
    want = jax_bwd(*map(jnp.asarray, (q, k, v, g)), om)
    got = _plain(*map(torch.from_numpy, (q, k, v, g, om)))
    assert got[3].dtype == torch.float32 and got[4].shape == (BH, L)
    for name, a, b in zip(('dq', 'dk', 'dv', 'u', 'w'), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_plain_passes_match_jax_kernels_bf16(jax_bwd):
    """Under bf16 both round the same dot operands and keep u and w in bf16
    (the TPU's bf16 ``uw`` residual)."""
    q, k, v, g, om = _inputs(1)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = jax_bwd(bf(q), bf(k), bf(v), bf(g), om)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = _plain(tb(q), tb(k), tb(v), tb(g), torch.from_numpy(om),
                 dot_dtype=torch.bfloat16)
    assert got[3].dtype == torch.bfloat16 and got[4].dtype == torch.bfloat16
    for name, a, b in zip(('dq', 'dk', 'dv', 'u', 'w'), got, want):
        a = a.to(torch.bfloat16).float().numpy()     # the kernels' bf16 outputs
        np.testing.assert_allclose(a, b, rtol=BF16_RTOL, atol=0, err_msg=name)


def _grads_jax(q, k, v, om, chunk):
    loss = lambda q_, k_, v_: jnp.sum(jla.favor_causal_attention(
        q_, k_, v_, jnp.asarray(om), chunk) ** 2)
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _grads_port(q, k, v, om, chunk):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tla.favor_causal_attention(*leaves, torch.from_numpy(om), chunk) ** 2
     ).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize('interpret', [True, False], ids=['fused', 'composed'])
def test_function_gradients_match_jax_grad(interpret, monkeypatch):
    """The autograd Function (plain passes on the CPU) against jax.grad of
    JAX's favor_causal_attention: its fused Pallas backward in interpret
    mode, or the autodiff of its composed path."""
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1' if interpret else '0')
    rng = np.random.RandomState(2)
    q, k, v = (_randn(rng, 2, 2, L, D) for _ in range(3))
    om = _omega(3)
    for a, b in zip(_grads_port(q, k, v, om, CHUNK),
                    _grads_jax(q, k, v, om, CHUNK)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_function_gradients_odd_length_match_jax_composed():
    """L=41, a ragged last chunk, against JAX's composed path."""
    rng = np.random.RandomState(4)
    q, k, v = (_randn(rng, 2, 3, 41, D) for _ in range(3))
    om = _omega(5)
    for a, b in zip(_grads_port(q, k, v, om, 16), _grads_jax(q, k, v, om, 16)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_function_gradcheck_float64():
    """Finite differences in float64 through the plain passes.  At eps=0
    the output is exactly invariant to the stabilizers, which carry no
    gradient; at eps > 0 they move it at the level of eps / den, which the
    finite differences would see."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (0.7 * torch.randn(1, 2, 11, 4, generator=gen, dtype=torch.float64)
               for _ in range(3))
    om = tla.draw_orthogonal_features(4, 8, gen).double()
    leaves = [t.requires_grad_() for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: tla.favor_causal_attention(a, b, c, om, 4, 0.0), leaves)


def test_omega_gets_no_gradient():
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 2, 16, D)).requires_grad_()
               for _ in range(3))
    om = torch.from_numpy(_omega(7)).requires_grad_()
    tla.favor_causal_attention(q, k, v, om, 8).sum().backward()
    assert om.grad is None or not om.grad.any()
    assert all(t.grad is not None and t.grad.abs().max() > 0 for t in (q, k, v))


def test_compose_takes_the_key_maxima():
    """The CPU forward hands its key maxima to the plain forward, which then
    gives what it gives when it finds the maxima itself."""
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(_randn(rng, 4, 40, D)) for _ in range(3))
    om = torch.from_numpy(_omega(9))
    kmax = tla._key_max_plain(k, om)
    torch.testing.assert_close(tla._favor_compose(q, k, v, om, 16, kmax=kmax),
                               tla._favor_compose(q, k, v, om, 16))
