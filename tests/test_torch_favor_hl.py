"""The port's heads-last FAVOR+ op (plain versions, CPU) against the JAX
package's ``favor_causal_attention_heads_last``, whose kernels #8-#11
(``_kmax_kernel_hl``, ``_fused_fwd_kernel_hl``, ``_fused_bwd_a_kernel_hl``,
``_fused_bwd_b_kernel_hl``) run in interpret mode: the output and the q/k/v
gradients in f32 and bf16, at an L that fills its chunks and a ragged one;
then the port's heads-last op against its own head-major op, the M > 128
guard of the kernel path, and omega's missing gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.ops import linear_attention as jla
from emo_disentanger_tpu_torch.ops import linear_attention as tla
from torch_port_helpers import ATOL, RTOL

B, H, DH, M = 2, 2, 8, 16
# bf16 gradients: both sides round the same dot operands to bf16 (the port's
# plain passes as the TPU kernels do) and keep (u, w) in bf16; held to one
# bf16 ulp (2^-7) of each tensor's largest element, the existing FAVOR bf16
# tolerance (tests/test_torch_favor_bwd.py)
BF16_RTOL = 2.0 ** -7
# bf16 output: the port's plain forward is the f32 composition, rounded once
# at the end, while JAX's kernel rounds phi_q, phi_k, the scores, S and z to
# bf16 before its products, so the two differ by a few bf16 roundings:
# 2^-5 of the largest |out|
BF16_OUT_RTOL = 2.0 ** -5


def _inputs(seed, L):
    rng = np.random.RandomState(seed)
    q, k, v, g = ((rng.randn(B, L, H * DH) * 0.7).astype(np.float32)
                  for _ in range(4))
    om = np.array(jla.draw_orthogonal_features(jax.random.PRNGKey(seed + 1),
                                               DH, M))
    return q, k, v, g, om


def _jax_heads_last(q, k, v, g, om, dtype):
    """JAX's heads-last op and its vjp, in a fresh closure (JAX reads
    EMODIS_HL_ATTN and EMODIS_PALLAS_INTERPRET while it traces)."""
    f = lambda q_, k_, v_: jla.favor_causal_attention_heads_last(
        q_, k_, v_, jnp.asarray(om), H)
    out, vjp = jax.vjp(f, *(jnp.asarray(a).astype(dtype) for a in (q, k, v)))
    grads = vjp(jnp.asarray(g).astype(dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)]


def _port(q, k, v, g, om, dtype, op=tla.favor_causal_attention_heads_last):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = op(*leaves, torch.from_numpy(om), H)
    out.backward(torch.from_numpy(g).to(dtype))
    return [out.detach()] + [t.grad for t in leaves]


def _rel_close(got, want, rtol, what):
    got = got.float().numpy()
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize('L', [256, 200], ids=['L256', 'ragged-L200'])
def test_matches_jax_heads_last_kernels_f32(L, monkeypatch):
    """f32 at the JAX suite's op tolerance.  At L=200 JAX pads to 256 and
    its key max also covers the zero-padded rows (h = 0 there), the port's
    the true L only: the two differ where the true max is negative, and then
    only at the level of the 1e-6 eps against the denominator."""
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1')
    assert jla._use_pallas()
    q, k, v, g, om = _inputs(0, L)
    want = _jax_heads_last(q, k, v, g, om, jnp.float32)
    got = _port(q, k, v, g, om, torch.float32)
    assert got[0].dtype == torch.float32 and got[0].shape == (B, L, H * DH)
    for name, a, b in zip(('out', 'dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize('L', [256, 200], ids=['L256', 'ragged-L200'])
def test_matches_jax_heads_last_kernels_bf16(L, monkeypatch):
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1')
    q, k, v, g, om = _inputs(1, L)
    want = _jax_heads_last(q, k, v, g, om, jnp.bfloat16)
    got = _port(q, k, v, g, om, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in got)
    _rel_close(got[0], want[0], BF16_OUT_RTOL, 'out')
    for name, a, b in zip(('dq', 'dk', 'dv'), got[1:], want[1:]):
        _rel_close(a, b, BF16_RTOL, name)


def _head_major(q, k, v, om, n_head):
    """The port's head-major op on the head-split tensors, merged back."""
    sp = lambda t: t.reshape(B, -1, n_head, DH).transpose(1, 2)
    out = tla.favor_causal_attention(sp(q), sp(k), sp(v), om)
    return out.transpose(1, 2).reshape(q.shape)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_equals_head_major_op_on_split_heads(dtype):
    """The same plain versions on the same rows: equal bit for bit, output
    and gradients, at a ragged L."""
    q, k, v, g, om = _inputs(2, 77)
    hl = _port(q, k, v, g, om, dtype)
    hm = _port(q, k, v, g, om, dtype, op=_head_major)
    for name, a, b in zip(('out', 'dq', 'dk', 'dv'), hl, hm):
        assert torch.equal(a, b), name


def test_more_than_128_features_refused_on_the_kernel_path(monkeypatch):
    """JAX's heads-last kernels refuse M > 128, and so does the port's
    kernel path (a tensor that is not on the CPU; 'meta' needs no card).
    The CPU path, like JAX's composed path, computes."""
    rng = np.random.RandomState(3)
    q, k, v = ((rng.randn(B, 64, H * DH) * 0.7).astype(np.float32)
               for _ in range(3))
    om = np.array(jla.draw_orthogonal_features(jax.random.PRNGKey(4), DH, 256))
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1')
    with pytest.raises(NotImplementedError, match='favor_dims <= 128'):
        jla.favor_causal_attention_heads_last(
            *(jnp.asarray(a) for a in (q, k, v, om)), H)
    meta = lambda a: torch.from_numpy(a).to('meta')
    with pytest.raises(NotImplementedError, match='favor_dims <= 128'):
        tla.favor_causal_attention_heads_last(meta(q), meta(k), meta(v),
                                              meta(om), H)
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '0')
    want = jla.favor_causal_attention_heads_last(
        *(jnp.asarray(a) for a in (q, k, v, om)), H)
    got = tla.favor_causal_attention_heads_last(
        *(torch.from_numpy(a) for a in (q, k, v, om)), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_omega_gets_no_gradient():
    q, k, v, _, om = _inputs(5, 40)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    omega = torch.from_numpy(om).requires_grad_()
    tla.favor_causal_attention_heads_last(*leaves, omega, H, 16).sum().backward()
    assert omega.grad is None or not omega.grad.any()
    assert all(t.grad is not None and t.grad.abs().max() > 0 for t in leaves)
