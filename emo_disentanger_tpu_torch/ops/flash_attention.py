"""Causal softmax attention forward for GPT-2's full-window forwards.

Port of the library kernel that ``emo_disentanger_tpu/models/gpt2.py:68-79``
calls for deterministic forwards of L >= 512, L % 128 == 0 (eval, decode
prefill, the window re-anchor): JAX's
``jax.experimental.pallas.ops.tpu.flash_attention(q, k, v, causal=True,
sm_scale=1/sqrt(Dh))`` on f32 q, k, v.  Its signature is kept, restricted
to what ``gpt2.py`` calls: no ``ab``, no ``segment_ids``, causal only.

On CUDA tensors :func:`flash_attention` launches the hand-written kernel of
``csrc/flash_attn_fwd.cu`` (f32 on the tensor cores in 3xTF32, Dh = 64, L a
multiple of 128, the tile the kernel takes and the only lengths
``gpt2.py`` dispatches); on CPU
tensors it runs the plain version, :func:`_flash_attention_plain`, which is
the library's ``mha_reference_no_custom_vjp``.  Only the forward exists: the
JAX package reaches no backward of this kernel (training takes the einsum
path, which has attention dropout).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# the library's DEFAULT_MASK_VALUE: -0.7 * float32 max
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
TILE = 128
HEAD_DIM = 64


def _flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           sm_scale: float) -> torch.Tensor:
    """f32 scores, the causal mask, an f32 softmax and the product with v."""
    logits = torch.einsum('bhqc,bhkc->bhqk', q, k)
    if sm_scale != 1.0:
        logits = logits * sm_scale
    Lq, Lk = q.shape[2], k.shape[2]
    causal = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril()
    logits = logits + torch.where(causal, 0.0, MASK_VALUE)
    unnormalized = torch.exp(logits - logits.amax(-1, keepdim=True))
    weights = unnormalized / unnormalized.sum(-1, keepdim=True)
    return torch.einsum('bhqk,bhkc->bhqc', weights, v)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # (q, k, v, o, BH, L, Dh, sm_scale, stream)
    'flash_attn_fwd': [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P],
}


def _lib():
    return _build.library('flash_attn_fwd', _SIGNATURES)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise unless q, k, v are contiguous f32 [B, H, L, 64] of one shape on
    one device, L a positive multiple of 128; returns (B, H, L, Dh)."""
    dev = q.device
    for name, t in (('q', q), ('k', k), ('v', v)):
        if (t.device != dev or t.dtype != torch.float32 or t.dim() != 4
                or not t.is_contiguous() or t.shape != q.shape):
            raise ValueError(
                f'{name}: {t.dtype} {tuple(t.shape)} on {t.device} '
                f'(contiguous={t.is_contiguous()}); expected contiguous float32 '
                f'{tuple(q.shape)} [B, H, L, Dh] on {dev}')
    B, H, L, Dh = q.shape
    if Dh != HEAD_DIM or L % TILE or L == 0:
        raise ValueError(f'flash_attention_fwd takes Dh={HEAD_DIM} and L a '
                         f'positive multiple of {TILE} (got Dh={Dh}, L={L})')
    return B, H, L, Dh


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: float) -> torch.Tensor:
    """Launch ``flash_attention_fwd`` on contiguous f32 [B, H, L, 64] q, k, v
    (L a multiple of 128); returns o [B, H, L, 64] f32."""
    dev = q.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel takes CUDA tensors (got {dev})')
    B, H, L, Dh = _check_inputs(q, k, v)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), B * H, L, Dh, sm_scale,
                             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'flash_attention_fwd')
    _build.LAUNCHES['flash_attention_fwd'] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float = 1.0) -> torch.Tensor:
    """Causal softmax attention: q, k, v [B, H, L, Dh] float32 ->
    [B, H, L, Dh] float32, scores ``sm_scale * q . k``.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if not causal:
        raise ValueError('only causal attention is ported (gpt2.py calls '
                         'flash_attention with causal=True)')
    if q.device.type == 'cpu':
        return _flash_attention_plain(q, k, v, sm_scale)
    return _flash_attention_cuda(q, k, v, sm_scale)
