"""One Performer decode layer for one token per batch element.

Port of ``emo_disentanger_tpu/ops/performer_decode.py``.  On CUDA tensors
:func:`fused_decode_layer` runs the hand-written kernel of
``csrc/performer_decode.cu`` (q/k/v projections, FAVOR+ features, the
in-place (S, z) update under ``update_mask``, attention, out-projection,
LayerNorm, ReLU FF, LayerNorm); on CPU tensors it runs the plain version,
:func:`_decode_layer_plain`, which is the composed decode path of
``emo_disentanger_tpu/models/performer.py:157-175``.

Any width up to D = H * Dh <= 2048, Dh <= 256, F <= 8192 and M <= 512 runs
on the kernel: shapes off its aligned designs' steps take the kernel's own
tail forms (``csrc/performer_decode.cu``'s note on widths), never the plain
version.

The state is float32 in either of JAX's layouts (``state_layout``): S
[B, H, Dh, M] in 'dm' or [B, H, M, Dh] in 'md' (the layout JAX's Pallas
kernel carries), and z [B, H, M].  The kernel reads and writes S at
``d * M + m`` or ``m * Dh + d`` and does the same arithmetic in the same
order in both, so an 'md' step is bit for bit the 'dm' step on the
transposed state.  Parameters use torch's layout (Linear weights
[out, in]) under the keys of :data:`PARAM_KEYS`.
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


def _decode_layer_plain(x, S, z, p, omega, update_mask, n_head,
                        state_layout='dm'):
    """The composed decode path: projections in the weights' dtype,
    ``favor_features`` (query max-stabilized, key stabilizer 0),
    ``linear_attention_decode_step`` in ``state_layout``, post-norm
    residual FF."""
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
        phi_q, phi_k, v.float(), S, z, update_mask=mask,
        state_layout=state_layout)
    S.copy_(S_new)
    z.copy_(z_new)
    x = x + lin(attn.to(x.dtype).reshape(B, D), p['wo'], p['bo'])
    y = x = F.layer_norm(x, (D,), p['g1'], p['be1'], LN_EPS)
    y = lin(F.relu(lin(y, p['w1'], p['b1'])), p['w2'], p['b2'])
    return F.layer_norm(x + y, (D,), p['g2'], p['be2'], LN_EPS)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # (x, x_bf16, params, w_bf16, omega, mask, S, s_md, z, out, scratch,
    #  counters, B, D, H, M, F, eps, ln_eps, stream)
    'performer_decode_layer': [_P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P,
                               _P, _I, _I, _I, _I, _I, _F, _F, _P],
    # (D, F) -> floats of scratch; () -> ints of zeroed counters
    'performer_decode_scratch_floats': [_I, _I],
    'performer_decode_counter_ints': [],
}


def _lib():
    return _build.library('performer_decode', _SIGNATURES)


# Host work a call repeats is done once: a layer's parameters are checked
# once per (address, dtype, shape, strides) of all 16 and their pointer
# array is kept; scratch and the kernel's zeroed counters are kept per
# (device, stream, D, F).  Both are bounded caches.
_CACHE_LIMIT = 256
_checked: Dict[tuple, object] = {}
_buffers: Dict[tuple, tuple] = {}


def _param_pointers(p, dev, D, Fd, wdt):
    key = tuple((p[k].data_ptr(), p[k].dtype, p[k].shape, p[k].stride())
                for k in PARAM_KEYS)
    ptrs = _checked.get(key)
    if ptrs is not None:
        return ptrs
    shapes = {'wq': (D, D), 'wk': (D, D), 'wv': (D, D), 'wo': (D, D),
              'w1': (Fd, D), 'w2': (D, Fd), 'b1': (Fd,)}
    for k in PARAM_KEYS:
        t = p[k]
        want = shapes.get(k, (D,))
        if (t.device != dev or t.dtype != wdt or tuple(t.shape) != want
                or not t.is_contiguous()):
            raise ValueError(f'param {k}: {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}; expected contiguous {wdt} {want} '
                             f'on {dev}')
    if len(_checked) >= _CACHE_LIMIT:
        _checked.clear()
    ptrs = (ctypes.c_void_p * len(PARAM_KEYS))(*(k[0] for k in key))
    _checked[key] = ptrs
    return ptrs


def _scratch(lib, dev, D, Fd):
    stream = torch.cuda.current_stream(dev)
    key = (dev, stream.cuda_stream, D, Fd)
    bufs = _buffers.get(key)
    if bufs is None:
        if len(_buffers) >= _CACHE_LIMIT:
            _buffers.clear()
        n = lib.performer_decode_scratch_floats(D, Fd)
        c = lib.performer_decode_counter_ints()
        bufs = (torch.empty(n, dtype=torch.float32, device=dev),
                torch.zeros(c, dtype=torch.int32, device=dev))
        _buffers[key] = bufs
    return bufs, stream.cuda_stream


# the widths ``performer_decode_layer`` takes: D = H * Dh, D <= MAX_D,
# Dh <= MAX_DH, F <= MAX_F, M <= MAX_M; any width in that range, the ones off
# the aligned designs' steps through the kernel's tail forms
MAX_D, MAX_DH, MAX_F, MAX_M = 2048, 256, 8192, 512


def _check_inputs(x, S, z, p, omega, update_mask, n_head, state_layout='dm'):
    """Raise unless the inputs are what ``performer_decode_layer`` takes
    (module docstring; D = H * Dh <= 2048, Dh <= 256, F <= 8192,
    1 <= M <= 512, S in ``state_layout``), all on x's device.
    Returns ((B, D, H, M, F), the weights' dtype, the parameters' pointer
    array, the f32 mask or None)."""
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f'x must be [B, D] (got {tuple(x.shape)})')
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
    if (H <= 0 or D % H or not 0 < D <= MAX_D or Dh > MAX_DH
            or not 0 < Fd <= MAX_F or not 0 < M <= MAX_M):
        raise ValueError(f'unsupported D={D}, H={H}, M={M}, F={Fd} (D = H * Dh '
                         f'with D <= {MAX_D} and Dh <= {MAX_DH}, F <= {MAX_F}, '
                         f'1 <= M <= {MAX_M})')
    if state_layout not in ('dm', 'md'):
        raise ValueError(f"unknown state_layout {state_layout!r}; expected "
                         "'dm' or 'md'")
    ptrs = _param_pointers(p, dev, D, Fd, wdt)
    s_shape = (B, H, Dh, M) if state_layout == 'dm' else (B, H, M, Dh)
    for name, t, want in (('S', S, s_shape), ('z', z, (B, H, M)),
                          ('omega', omega, (Dh, M))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(f'{name}: {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}; expected contiguous float32 {want}')
    mask = None
    if update_mask is not None:
        if update_mask.shape != (B,) or update_mask.device != dev:
            raise ValueError('update_mask must be [B] on the same device')
        mask = update_mask.to(torch.float32).contiguous()
    return (B, D, H, M, Fd), wdt, ptrs, mask


def _decode_layer_cuda(x, S, z, p, omega, update_mask, n_head,
                       state_layout='dm'):
    """Launch ``performer_decode_layer`` (checks, allocation, launch)."""
    dev = x.device
    if dev.type != 'cuda':
        raise ValueError(f'the CUDA kernel takes CUDA tensors (got {dev})')
    (B, D, H, M, Fd), wdt, ptrs, mask = _check_inputs(
        x, S, z, p, omega, update_mask, n_head, state_layout)
    w_bf16 = int(wdt == torch.bfloat16)
    lib = _lib()
    (scratch, counters), stream = _scratch(lib, dev, D, Fd)
    out = torch.empty_like(x)
    err = lib.performer_decode_layer(
        x.data_ptr(), int(x.dtype == torch.bfloat16), ptrs, w_bf16,
        omega.data_ptr(), None if mask is None else mask.data_ptr(),
        S.data_ptr(), int(state_layout == 'md'), z.data_ptr(), out.data_ptr(),
        scratch.data_ptr(),
        counters.data_ptr(), B, D, H, M, Fd, EPS, LN_EPS, stream)
    _build.check(lib, err, 'performer_decode_layer')
    _build.LAUNCHES['performer_decode_layer'] += 1
    return out


def fused_decode_layer(x: torch.Tensor, S: torch.Tensor, z: torch.Tensor,
                       p: Dict[str, torch.Tensor], omega: torch.Tensor,
                       update_mask: Optional[torch.Tensor] = None, *,
                       n_head: int, state_layout: str = 'dm') -> torch.Tensor:
    """One Performer decode-layer step.

    x [B, D] (f32 or bf16); S and z [B, H, M] float32 carried state, S
    [B, H, Dh, M] in 'dm' or [B, H, M, Dh] in 'md' (``state_layout``),
    **updated in place**; ``p`` maps :data:`PARAM_KEYS` to the
    layer's parameters (Linear weights [out, in], all in one dtype);
    omega [Dh, M] float32; ``update_mask`` [B] (bool or 0/1) freezes masked
    elements' state.  Returns the layer output [B, D] in x's dtype.

    CPU tensors run the plain composed path; CUDA tensors launch the
    kernel."""
    if x.device.type == 'cpu':
        return _decode_layer_plain(x, S, z, p, omega, update_mask, n_head,
                                   state_layout)
    return _decode_layer_cuda(x, S, z, p, omega, update_mask, n_head,
                              state_layout)
