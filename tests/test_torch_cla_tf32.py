"""Why kernel #5 (``cla_fwd``) runs its products in 3xTF32: its arithmetic
emulated on the CPU.

The kernel runs the chunk recursion of causal linear attention over 64-row
chunks: the scores phi_q phi_k^T masked to j <= i, the denominator
sum_j sc_ij + phi_q . z + eps on the CUDA cores in f32, the numerator
sc v + phi_q S, and the update S += phi_k^T v, z += sum_j phi_k_j.  Each of
the four products runs on the tensor cores in TF32, which keeps 10 mantissa
bits, with each operand x split as favor_tc.cuh's ``split_tf32`` splits it:
hi = x truncated to TF32 and lo = rna_tf32(x - hi), and lo*hi + hi*lo +
hi*hi summed in f32.  Here that arithmetic runs in torch at a small size
(BH = 2, a ragged L = 200, M = 36 and Dv = 20, padded to 48 and 32 as the
kernel pads them) on numpy-seeded features, f32 and widened from bf16, and
is held against JAX's ``causal_linear_attention`` with its Pallas kernel in
interpret mode: within a tenth of the card's f32 tolerance, where one TF32
pass is not.  bf16 inputs widen to values whose lo is 0, so their products
of two inputs (the scores and the update) are exact in one TF32 pass; the
numerator's operands sc and S are f32 sums and are not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.ops import linear_attention as jla

TOL_F32 = 1e-4          # chip_smoke.TOL_F32
C = 64                  # the kernel's chunk
EPS = 1e-6
BH, L, M, DV = 2, 200, 36, 20


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from 0,
    as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """favor_tc.cuh's split: hi truncated to TF32, lo the rest rounded."""
    hi = (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, tf32_rna(x - hi)


def mm(a, b, passes):
    """a @ b with TF32 operands and f32 sums: 3 passes (lo*hi + hi*lo +
    hi*hi) or 1 (hi*hi).  TF32 products are exact in f32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def pad(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def cla_fwd_emulated(q, k, v, passes=(3, 3)):
    """#5's chunk recursion on f32 [BH, L, M] features and [BH, L, Dv] v;
    ``passes`` = (the products of two inputs: scores and update, the
    numerator's two products)."""
    inputs, num_passes = passes
    bh, n_pos, m = q.shape
    dv = v.shape[-1]
    m16, d16 = -(-m // 16) * 16, -(-dv // 16) * 16
    q, k, v = pad(q, m16), pad(k, m16), pad(v, d16)
    S = torch.zeros(bh, m16, d16)
    z = torch.zeros(bh, m16)
    causal = torch.ones(C, C, dtype=torch.bool).tril()
    outs = []
    for r0 in range(0, n_pos, C):
        n = min(C, n_pos - r0)
        rows = lambda t: torch.nn.functional.pad(t[:, r0:r0 + n], (0, 0, 0, C - n))
        pq, pk, vv = rows(q), rows(k), rows(v)
        sc = torch.where(causal, mm(pq, pk.transpose(1, 2), inputs), 0.0)
        den = sc.sum(-1) + (pq * z[:, None]).sum(-1) + EPS
        num = mm(sc, vv, num_passes) + mm(pq, S, num_passes)
        outs.append((num / den[..., None])[:, :n, :dv])
        S = S + mm(pk.transpose(1, 2), vv, inputs)
        z = z + pk.sum(1)
    return torch.cat(outs, dim=1)


def _inputs(dtype):
    """phi_q, phi_k uniform in [0.01, 1] (as the composed op's tests draw
    them), v normal; numpy-seeded, rounded to ``dtype`` and widened."""
    rng = np.random.RandomState(13)
    pq, pk = (rng.uniform(0.01, 1.0, (BH, L, M)).astype(np.float32) for _ in range(2))
    v = rng.randn(BH, L, DV).astype(np.float32)
    return [torch.from_numpy(a).to(dtype).float() for a in (pq, pk, v)]


def _rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got.double().numpy() - want).max() / np.abs(want).max())


def test_split_is_truncated_hi_and_rounded_lo():
    x = torch.tensor([1.0 + 2 ** -11 + 2 ** -12, -(1.0 + 3 * 2 ** -12), 1.0 + 2 ** -10])
    hi, lo = split_tf32(x)
    assert torch.equal(hi, torch.tensor([1.0, -1.0, 1.0 + 2 ** -10]))
    assert torch.equal(lo, torch.tensor([2 ** -11 + 2 ** -12, -3 * 2 ** -12, 0.0]))
    wide = torch.randn(1000, generator=torch.Generator().manual_seed(0)).bfloat16().float()
    assert torch.equal(split_tf32(wide)[0], wide)
    assert not split_tf32(wide)[1].any()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_three_pass_tf32_forward_holds_f32_tolerance(monkeypatch, dtype):
    """The emulated kernel within TOL_F32 / 10 of JAX's Pallas kernel in
    interpret mode; one TF32 pass everywhere exceeds it.  With bf16 inputs
    one pass on the scores and the update alone changes no bit; with f32
    inputs it exceeds the tolerance too."""
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1')
    q, k, v = _inputs(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jla.causal_linear_attention(
        *(jnp.asarray(t.numpy()).astype(jdt) for t in (q, k, v)), C, EPS)
    got = {p: cla_fwd_emulated(q, k, v, p) for p in ((3, 3), (1, 1), (1, 3))}
    err = {p: _rel(out, want) for p, out in got.items()}
    print(f'{dtype}: 3xTF32 rel err {err[3, 3]:.2e}, one TF32 pass {err[1, 1]:.2e}, '
          f'one pass on the input products alone {err[1, 3]:.2e} (tol {TOL_F32 / 10:.0e})')
    assert got[3, 3].shape == (BH, L, DV)
    assert err[3, 3] <= TOL_F32 / 10
    assert err[1, 1] > TOL_F32 / 10
    if dtype == torch.bfloat16:
        assert torch.equal(got[1, 3], got[3, 3])
    else:
        assert err[1, 3] > TOL_F32 / 10
