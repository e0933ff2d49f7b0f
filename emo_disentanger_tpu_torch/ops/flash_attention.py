"""Causal softmax attention forward for GPT-2's full-window forwards.

Port of the library kernel that ``emo_disentanger_tpu/models/gpt2.py:68-79``
calls for deterministic forwards of L >= 512, L % 128 == 0 (eval, decode
prefill, the window re-anchor): JAX's
``jax.experimental.pallas.ops.tpu.flash_attention(q, k, v, causal=True,
sm_scale=1/sqrt(Dh))`` on f32 q, k, v.  Its signature is kept, restricted
to what ``gpt2.py`` calls: no ``ab``, no ``segment_ids``, causal only.

On CUDA tensors :func:`flash_attention` launches the hand-written kernel of
``csrc/flash_attn_fwd.cu`` (f32 on the tensor cores in 3xTF32, L a
multiple of 128, the only lengths ``gpt2.py`` dispatches, and any head
width up to 256: the kernel is built for head-width tiles of 32, 64, 128
and 256, and a width between tiles is zero-padded to the next one by
:func:`_pad_heads`, which changes no score and no kept output value); on CPU
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
# the head-width tiles the kernel is built for; Dh <= MAX_HEAD_DIM
HEAD_TILES = (32, 64, 128, 256)
MAX_HEAD_DIM = HEAD_TILES[-1]


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
    """Raise unless q, k, v are contiguous f32 [B, H, L, Dh] of one shape on
    one device, 1 <= Dh <= 256 and L a positive multiple of 128; returns
    (B, H, L, Dh)."""
    dev = q.device
    for name, t in (('q', q), ('k', k), ('v', v)):
        if (t.device != dev or t.dtype != torch.float32 or t.dim() != 4
                or not t.is_contiguous() or t.shape != q.shape):
            raise ValueError(
                f'{name}: {t.dtype} {tuple(t.shape)} on {t.device} '
                f'(contiguous={t.is_contiguous()}); expected contiguous float32 '
                f'{tuple(q.shape)} [B, H, L, Dh] on {dev}')
    B, H, L, Dh = q.shape
    if not 1 <= Dh <= MAX_HEAD_DIM or L % TILE or L == 0:
        raise ValueError(f'flash_attention_fwd takes 1 <= Dh <= {MAX_HEAD_DIM} '
                         f'and L a positive multiple of {TILE} (got Dh={Dh}, '
                         f'L={L})')
    return B, H, L, Dh


def head_tile(Dh: int) -> int:
    """The smallest head-width tile of the kernel that holds Dh."""
    return next(t for t in HEAD_TILES if t >= Dh)


def _pad_heads(x: torch.Tensor, tile: int) -> torch.Tensor:
    """x [B, H, L, Dh] zero-padded along Dh to ``tile`` columns (x itself
    when Dh is the tile): zero columns add nothing to q . k, and v's give
    output columns that :func:`_flash_attention_padded` drops."""
    pad = tile - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)).contiguous() if pad else x


def _flash_attention_padded(q, k, v, sm_scale, attend):
    """Pad q, k, v to Dh's tile, run ``attend(q, k, v, sm_scale)`` on the
    padded tensors and return the true Dh columns: the wrapper's padding,
    as a plain function the CPU tests run with the plain version as
    ``attend``."""
    Dh = q.shape[-1]
    tile = head_tile(Dh)
    out = attend(*(_pad_heads(t, tile) for t in (q, k, v)), sm_scale)
    return out if tile == Dh else out[..., :Dh].contiguous()


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: float) -> torch.Tensor:
    """Launch ``flash_attention_fwd`` on contiguous f32 [B, H, L, Dh] q, k, v
    (1 <= Dh <= 256, L a multiple of 128), padded along Dh to the kernel's
    tile when Dh is not one; returns o [B, H, L, Dh] f32."""
    dev = q.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel takes CUDA tensors (got {dev})')
    _check_inputs(q, k, v)
    return _flash_attention_padded(q, k, v, sm_scale, _launch)


def _launch(q, k, v, sm_scale):
    """One launch on q, k, v [B, H, L, tile] (the checks done)."""
    B, H, L, Dh = q.shape
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), B * H, L, Dh, sm_scale,
                             torch.cuda.current_stream(q.device).cuda_stream)
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
