"""One Performer decode layer for one token per batch element.

Port of ``emo_disentanger_tpu/ops/performer_decode.py``.  On CUDA tensors
:func:`fused_decode_layer` runs the hand-written kernel of
``csrc/performer_decode.cu`` (q/k/v projections, FAVOR+ features, the
in-place (S, z) update under ``update_mask``, attention, out-projection,
LayerNorm, ReLU FF, LayerNorm); on CPU tensors it runs the plain version,
:func:`_decode_layer_plain`, which is the composed decode path of
``emo_disentanger_tpu/models/performer.py:157-175``.

The state is carried in the 'dm' layout: S [B, H, Dh, M], z [B, H, M], both
float32.  Parameters use torch's layout (Linear weights [out, in]) under
the keys of :data:`PARAM_KEYS`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import _build
from .linear_attention import EPS, favor_features, linear_attention_decode_step

LN_EPS = 1e-5
PARAM_KEYS = ('wq', 'bq', 'wk', 'bk', 'wv', 'bv', 'wo', 'bo',
              'w1', 'b1', 'w2', 'b2', 'g1', 'be1', 'g2', 'be2')


def _decode_layer_plain(x, S, z, p, omega, update_mask, n_head):
    """The composed decode path: projections in the weights' dtype,
    ``favor_features`` (query max-stabilized, key stabilizer 0),
    ``linear_attention_decode_step`` in 'dm', post-norm residual FF."""
    B, D = x.shape
    Dh = D // n_head
    lin = lambda t, w, b: F.linear(t.to(w.dtype), w, b)
    q = lin(x, p['wq'], p['bq']).reshape(B, n_head, Dh)
    k = lin(x, p['wk'], p['bk']).reshape(B, n_head, Dh)
    v = lin(x, p['wv'], p['bv']).reshape(B, n_head, Dh)
    phi_q = favor_features(q, omega, is_query=True)
    phi_k = favor_features(k, omega, is_query=False, key_stabilizer=0.0)
    mask = None if update_mask is None else update_mask[:, None]
    attn, S_new, z_new = linear_attention_decode_step(
        phi_q, phi_k, v.float(), S, z, update_mask=mask, state_layout='dm')
    S.copy_(S_new)
    z.copy_(z_new)
    x = x + lin(attn.to(x.dtype).reshape(B, D), p['wo'], p['bo'])
    y = x = F.layer_norm(x, (D,), p['g1'], p['be1'], LN_EPS)
    y = lin(F.relu(lin(y, p['w1'], p['b1'])), p['w2'], p['b2'])
    return F.layer_norm(x + y, (D,), p['g2'], p['be2'], LN_EPS)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # (x, x_bf16, params, w_bf16, omega, mask, S, z, out, scratch,
    #  B, D, H, M, F, eps, ln_eps, stream)
    'performer_decode_layer': [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _F, _F, _P],
}


def _lib():
    return _build.library('performer_decode', _SIGNATURES)


def _decode_layer_cuda(x, S, z, p, omega, update_mask, n_head):
    """Launch ``performer_decode_layer`` (checks, allocation, launch)."""
    dev = x.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel takes CUDA tensors (got {dev})')
    B, D = x.shape
    H = n_head
    Dh = D // H
    M = omega.shape[-1]
    Fd = p['w1'].shape[0]
    wdt = p['wq'].dtype
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f'x must be contiguous f32 or bf16 (got {x.dtype})')
    if wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f'weights must be f32 or bf16 (got {wdt})')
    shapes = {'wq': (D, D), 'wk': (D, D), 'wv': (D, D), 'wo': (D, D),
              'w1': (Fd, D), 'w2': (D, Fd), 'b1': (Fd,)}
    for key in PARAM_KEYS:
        t = p[key]
        want = shapes.get(key, (D,))
        if (t.device != dev or t.dtype != wdt or tuple(t.shape) != want
                or not t.is_contiguous()):
            raise ValueError(f'param {key}: {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}; expected contiguous {wdt} {want} '
                             f'on {dev}')
    for name, t, want in (('S', S, (B, H, Dh, M)), ('z', z, (B, H, M)),
                          ('omega', omega, (Dh, M))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(f'{name}: {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}; expected contiguous float32 {want}')
    if D % H or M % 32 or not 32 <= M <= 1024:
        raise ValueError(f'unsupported D={D}, H={H}, M={M} (M a multiple of '
                         '32 in [32, 1024])')
    mask = None
    if update_mask is not None:
        if update_mask.shape != (B,) or update_mask.device != dev:
            raise ValueError('update_mask must be [B] on the same device')
        mask = update_mask.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    scratch = torch.empty(B * (7 * D + Fd), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * len(PARAM_KEYS))(*(p[k].data_ptr()
                                                 for k in PARAM_KEYS))
    lib = _lib()
    err = lib.performer_decode_layer(
        x.data_ptr(), int(x.dtype == torch.bfloat16), ptrs,
        int(wdt == torch.bfloat16), omega.data_ptr(),
        None if mask is None else mask.data_ptr(), S.data_ptr(), z.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), B, D, H, M, Fd, EPS, LN_EPS,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'performer_decode_layer')
    _build.LAUNCHES['performer_decode_layer'] += 1
    return out


def fused_decode_layer(x: torch.Tensor, S: torch.Tensor, z: torch.Tensor,
                       p: Dict[str, torch.Tensor], omega: torch.Tensor,
                       update_mask: Optional[torch.Tensor] = None, *,
                       n_head: int) -> torch.Tensor:
    """One Performer decode-layer step.

    x [B, D] (f32 or bf16); S [B, H, Dh, M] / z [B, H, M] float32 carried
    state ('dm'), **updated in place**; ``p`` maps :data:`PARAM_KEYS` to the
    layer's parameters (Linear weights [out, in], all in one dtype);
    omega [Dh, M] float32; ``update_mask`` [B] (bool or 0/1) freezes masked
    elements' state.  Returns the layer output [B, D] in x's dtype.

    CPU tensors run the plain composed path; CUDA tensors launch the
    kernel."""
    if x.device.type == 'cpu':
        return _decode_layer_plain(x, S, z, p, omega, update_mask, n_head)
    return _decode_layer_cuda(x, S, z, p, omega, update_mask, n_head)
