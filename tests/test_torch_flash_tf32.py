"""Why kernel #13 splits its operands: 3xTF32 emulated on the CPU.

The kernel runs q k^T and p v on the tensor cores in TF32, which keeps 10
mantissa bits.  Each operand x is split into hi = rna_tf32(x) and
lo = rna_tf32(x - hi), and hi*hi + hi*lo + lo*hi is summed in f32.  Here the
rounding is emulated in torch (the low 13 mantissa bits rounded to nearest,
ties away from zero, as ``cvt.rna.tf32.f32`` does) inside a plain causal
attention, and held against ``_flash_attention_plain`` in float64 at the
kernel's input scale (``chip_smoke.FLASH_STD``): the split must stay within
a tenth of the card's f32 tolerance, where one TF32 pass does not."""

import numpy as np
import torch

from emo_disentanger_tpu_torch.ops.flash_attention import (
    MASK_VALUE, _flash_attention_plain)

TOL_F32 = 1e-4          # chip_smoke.TOL_F32
FLASH_STD = 2.0         # chip_smoke.FLASH_STD


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _mm(a, b, passes):
    """a @ b with TF32 operands and f32 sums: 3 passes (hi*hi + hi*lo +
    lo*hi) or 1 (hi*hi).  TF32 products are exact in f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _attention(q, k, v, scale, passes):
    s = _mm(q, k.transpose(-1, -2), passes) * scale
    L = q.shape[-2]
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    s = s + torch.where(causal, 0.0, MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _mm(p, v, passes) / p.sum(-1, keepdim=True)


def test_tf32_rounding_is_round_to_nearest():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 3 * 2 ** -12),
                      1.0 + 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0])
    assert torch.equal(tf32_rna(x), want)
    hi, lo = _split(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert bool((hi.view(torch.int32) & 0x1FFF == 0).all())


def test_three_pass_tf32_attention_holds_f32_tolerance():
    rng = np.random.RandomState(0)
    B, H, L, Dh = 1, 2, 512, 64
    q, k, v = (torch.from_numpy(FLASH_STD * rng.randn(B, H, L, Dh).astype(np.float32))
               for _ in range(3))
    scale = 1.0 / Dh ** 0.5
    ref = _flash_attention_plain(q.double(), k.double(), v.double(), scale)
    err = {}
    for passes in (3, 1):
        got = _attention(q, k, v, scale, passes).double()
        err[passes] = float((got - ref).abs().max() / ref.abs().max())
    print(f'3xTF32 rel err {err[3]:.2e}, one TF32 pass {err[1]:.2e} '
          f'(tol {TOL_F32 / 10:.0e})')
    assert err[3] <= TOL_F32 / 10
    assert err[1] > TOL_F32 / 10
