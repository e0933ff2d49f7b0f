"""Decode attention over a KV cache for dense attention.

Port of ``emo_disentanger_tpu/ops/attention.py``: the einsum equations of a
decode step over a cache in each of JAX's three layouts, the
per-element-clock row write, and the three decode attentions of the stage-1
Transformer-XL, each with the relative-position score term
``BD[j] = rr_q . r_heads[t - j]``:

* ``flash_decode_attention``: the chunked online-softmax decode over the
  live prefix [0, t] only, the relative term per chunk ('khd' only, as in
  JAX);
* ``full_decode_attention``: the whole padded cache, masked past ``t``;
* ``full_decode_attention_pe``: the same with a per-element clock ``t`` [B]
  (continuous batching).

``txl_decode_attention_pe`` is the stage-1 model's whole per-element-clock
cache work: the k and v row writes (``write_row_pe``) and
``full_decode_attention_pe`` with the r_w / r_r biases added to q.  On CPU
tensors it runs exactly that composition; on CUDA tensors it launches the
hand-written kernel of ``csrc/txl_decode_attn.cu``, which writes the rows
and reads each slot's live prefix [0, min(t, K - 1)] where it lies, in any
of the three layouts, and never the rows past the clock.  JAX has no
kernel here (its ``full_decode_attention_pe`` is jnp); the einsums over a
'khd' cache copied the whole cache every layer.

Cache layouts (a layer's cache; the model's caches add a leading n_layer):

* ``'khd'`` [B, K, H, Dh], the position heads r_heads [K, H, Dh];
* ``'hkd'`` [B, H, K, Dh] and ``'dk'`` [B, H, Dh, K], both with r_heads
  [H, Dh, K].

The head-major layouts make each (b, h) a matrix at one batch stride, so
the scores and the value product are batched matrix products that read
the cache where it lies, also through a leading view along K (the cache
ladder's tiers); a 'khd' cache must first be copied into that form.  All
three give the same function up to the order of the sums.

Scores and the value product of the plain versions run as einsums in the
cache's dtype; the softmax (and the flash recurrence) runs in float32, and
the probabilities round to the cache's dtype before the value product, as
in JAX.  The kernel keeps the scores, the softmax and the value sum in
float32 and does not round the probabilities.  JAX's
``EMODIS_PE_WRITE_IMPL`` and ``EMODIS_PE_REL_IMPL`` pick lowerings of the
same write and relative term (tested identical there); the port has one of
each: an in-place indexed store, and the 'slice' form.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

from . import _build

NEG_INF = -1e30

VALID_LAYOUTS = ('khd', 'dk', 'hkd')
# the K axis of a layer's cache [B, ...] in each layout
K_AXIS = {'khd': 1, 'hkd': 2, 'dk': 3}


def layout_equations(layout: str):
    """(scores, value) einsum equations for a decode cache in ``layout``:
    q [B, H, Dh] x cache -> scores [B, H, K]; probs [B, H, K] x cache ->
    [B, H, Dh]."""
    if layout == 'dk':        # cache [B, H, Dh, K]
        return 'bhd,bhdj->bhj', 'bhj,bhdj->bhd'
    if layout == 'hkd':       # cache [B, H, K, Dh]
        return 'bhd,bhjd->bhj', 'bhj,bhjd->bhd'
    if layout == 'khd':       # cache [B, K, H, Dh]
        return 'bhd,bjhd->bhj', 'bhj,bjhd->bhd'
    raise ValueError(f'unknown cache layout {layout!r}; '
                     f'expected one of {VALID_LAYOUTS}')


def cache_positions(cache_layer: torch.Tensor, layout: str) -> int:
    """K, the positions of a layer's cache [B, ...] in ``layout``."""
    layout_equations(layout)
    return cache_layer.shape[K_AXIS[layout]]


def _store(cache_layer, rows, at, row, layout):
    """``cache_layer`` at (element ``rows``, position ``at``) = ``row``
    [n, H, Dh], in place."""
    if layout == 'khd':
        cache_layer[rows, at] = row
    elif layout == 'hkd':
        cache_layer[rows, :, at] = row
    else:
        cache_layer[rows, :, :, at] = row


def write_row(cache_layer: torch.Tensor, new_row: torch.Tensor, t: int,
              layout: str = 'khd') -> torch.Tensor:
    """Shared-clock cache write: ``new_row`` [B, H, Dh] lands at position
    ``t`` of every element of ``cache_layer``, in place, clamped to the
    cache as JAX's ``dynamic_update_slice`` clamps; returns
    ``cache_layer``."""
    at = min(max(int(t), 0), cache_positions(cache_layer, layout) - 1)
    _store(cache_layer, slice(None), at, new_row.to(cache_layer.dtype), layout)
    return cache_layer


def write_row_pe(cache_layer: torch.Tensor, new_row: torch.Tensor,
                 t: torch.Tensor, layout: str = 'khd') -> torch.Tensor:
    """Per-element-clock cache write: ``new_row`` [B, H, Dh] lands at each
    element's own position ``t[b]`` of ``cache_layer`` (any layout),
    **in place**; returns ``cache_layer``.  Positions are clamped to
    [0, K - 1], as JAX's ``dynamic_update_slice`` clamps its start index."""
    K = cache_positions(cache_layer, layout)
    rows = torch.arange(cache_layer.shape[0], device=cache_layer.device)
    _store(cache_layer, rows, t.clamp(0, K - 1),
           new_row.to(cache_layer.dtype), layout)
    return cache_layer


def flash_decode_attention(
    q: torch.Tensor,              # [B, H, Dh]  (for TXL: q + r_w_bias)
    k_cache: torch.Tensor,        # [B, Kmax, H, Dh]
    v_cache: torch.Tensor,        # [B, Kmax, H, Dh]
    t: int,                       # the position just written
    *,
    scale: float,
    chunk: int = 256,
    rel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """[B, H, Dh] attention over positions 0..t (inclusive), in
    ``t // chunk + 1`` chunks of ``min(chunk, Kmax)`` positions with an
    online softmax (``ops/attention.py:99-166``).  ``rel = (rr_q,
    r_heads)``: rr_q [B, H, Dh] (q + r_r_bias), r_heads [R, H, Dh] the
    relative-position heads by distance.

    Each chunk's distances form the reversed contiguous range
    [e - chunk + 1, e], e = t - c0: one slice of r_heads from
    ``s0 = clip(e - chunk + 1, 0, Kmax - chunk)``, flipped, zero-padded by
    a chunk and read from ``start = chunk - 1 - (e - s0)``, as in JAX.  A
    chunk that would run past Kmax is cut at Kmax (where JAX's
    ``dynamic_slice`` would shift the keys back and misalign them with the
    mask and the distances: possible only when chunk does not divide
    Kmax)."""
    B, Kmax, H, Dh = k_cache.shape
    chunk = min(chunk, Kmax)
    t = int(t)
    if rel is not None:
        rr_q, r_heads = rel
        rr_q = rr_q.to(r_heads.dtype)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Dh), dtype=torch.float32, device=q.device)
    qk = q.to(k_cache.dtype)
    for ci in range(t // chunk + 1):
        c0 = ci * chunk
        n = min(chunk, Kmax - c0)
        kk = k_cache[:, c0:c0 + n]
        vv = v_cache[:, c0:c0 + n]
        s = torch.einsum('bhd,bjhd->bhj', qk, kk).float()
        if rel is not None:
            e = t - c0
            s0 = min(max(e - chunk + 1, 0), Kmax - chunk)
            rq = torch.einsum('bhd,khd->bhk', rr_q, r_heads[s0:s0 + chunk])
            rq = torch.nn.functional.pad(rq.float().flip(-1), (0, chunk))
            start = (chunk - 1) - (e - s0)
            s = s + rq[..., start:start + n]
        s = s * scale
        jj = c0 + torch.arange(n, device=q.device)
        s = torch.where((jj > t)[None, None, :], NEG_INF, s)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            'bhj,bjhd->bhd', p.to(vv.dtype), vv).float()
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


def full_decode_attention(
    q: torch.Tensor,              # [B, H, Dh]
    k_cache: torch.Tensor,        # a layer's cache in ``layout``
    v_cache: torch.Tensor,        # like k_cache
    t: int,                       # one position for every element
    *,
    scale: float,
    rel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    layout: str = 'khd',
) -> torch.Tensor:
    """The function of :func:`flash_decode_attention` over the whole padded
    cache, masked past ``t`` (``ops/attention.py:169-270``).  'khd' gathers
    the distance rows of r_heads [R, H, Dh] at ``clip(t - j, 0, R - 1)``
    and dots them with rr_q; the head-major layouts (r_heads [H, Dh, R])
    first take ``rq_all = rr_q . r_heads`` for every distance row and
    gather the scores at the same distances, which is the same dot for
    each entry."""
    eq_s, eq_v = layout_equations(layout)
    Kmax = cache_positions(k_cache, layout)
    t = int(t)
    s = torch.einsum(eq_s, q.to(k_cache.dtype), k_cache).float()
    pos = torch.arange(Kmax, device=q.device)
    if rel is not None:
        rr_q, r_heads = rel
        if layout == 'khd':
            rsel = r_heads[(t - pos).clamp(0, r_heads.shape[0] - 1)]
            s = s + torch.einsum('bhd,jhd->bhj', rr_q.to(rsel.dtype),
                                 rsel).float()
        else:
            rq_all = torch.einsum('bhd,hdk->bhk', rr_q.to(r_heads.dtype),
                                  r_heads).float()
            s = s + rq_all[..., (t - pos).clamp(0, r_heads.shape[-1] - 1)]
    s = s * scale
    s = torch.where((pos > t)[None, None, :], NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    return torch.einsum(eq_v, p.to(v_cache.dtype), v_cache).to(q.dtype)


def full_decode_attention_pe(
    q: torch.Tensor,              # [B, H, Dh]
    k_cache: torch.Tensor,        # a layer's cache in ``layout``
    v_cache: torch.Tensor,        # like k_cache
    t: torch.Tensor,              # [B] per-element positions
    *,
    scale: float,
    rel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    layout: str = 'khd',
) -> torch.Tensor:
    """:func:`full_decode_attention` with a per-element clock ``t`` [B]
    (``ops/attention.py:273-351``, JAX's default 'slice' form of the
    relative term): ``rq_all[b, h, d] = rr_q . r_heads[d]`` for every
    distance row d (r_heads [R, H, Dh] in 'khd', [H, Dh, R] in the
    head-major layouts), reversed and zero-padded by Kmax - 1, and each
    element reads its window ``bd[b, h, j] = rev[b, h, (R - 1 - t_b) + j]``;
    positions j > t_b read the pad, which the mask kills.  The window start
    is clamped to [0, R - 1] as ``dynamic_slice`` clamps it, so a dead slot
    whose clock ran past the cache still reads in bounds.  Needs
    R >= Kmax."""
    eq_s, eq_v = layout_equations(layout)
    B, Kmax = k_cache.shape[0], cache_positions(k_cache, layout)
    s = torch.einsum(eq_s, q.to(k_cache.dtype), k_cache).float()
    if rel is not None:
        rr_q, r_heads = rel
        khd = layout == 'khd'
        R = r_heads.shape[0] if khd else r_heads.shape[-1]
        if R < Kmax:
            raise ValueError(f'the relative heads need at least Kmax={Kmax} '
                             f'distance rows (got {R})')
        rq_all = torch.einsum('bhd,khd->bhk' if khd else 'bhd,hdk->bhk',
                              rr_q.to(r_heads.dtype), r_heads).float()
        rev = torch.nn.functional.pad(rq_all.flip(-1), (0, Kmax - 1))
        start = (R - 1 - t).clamp(0, R - 1)
        windows = rev.unfold(-1, Kmax, 1)              # [B, H, R, Kmax]
        s = s + windows[torch.arange(B, device=t.device), :, start]
    s = s * scale
    masked = torch.arange(Kmax, device=t.device)[None, :] > t[:, None]
    s = torch.where(masked[:, None, :], NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    return torch.einsum(eq_v, p.to(v_cache.dtype), v_cache).to(q.dtype)


# --------------------------------------------------------------------------
# the stage-1 decode step's cache work with a clock per slot

# the widths the kernel takes: Dh <= TXL_MAX_DH, and H times a head's
# threads (ceil(Dh / 8) rounded up to a power of two) at most 256
TXL_MAX_DH = 256
_TXL_GROUP_THREADS = 256
# a slot's live rows are split over about this many blocks per SM in all
# (at least 32 rows a block): 256 slots on 132 SMs take 5 blocks a slot,
# the fastest of 2 to 64 a SM at the txl.serve cell's clocks on the H100
TXL_BLOCKS_PER_SM = 8
TXL_MIN_ROWS = 32


def _head_threads(Dh: int) -> int:
    n = 1
    while n * 8 < Dh:
        n *= 2
    return n


def _check_txl_inputs(q, k_new, v_new, k_cache, v_cache, t, r_heads,
                      r_w_bias, r_r_bias, layout):
    """Raise unless the inputs are what ``txl_decode_attn`` takes: q, k_new,
    v_new [B, H, Dh] with (H, Dh) contiguous; k and v caches of one shape
    and strides in ``layout``; r_heads [R, H, Dh] ('khd') or [H, Dh, R]
    with R >= K; the biases [H, Dh]; all of one dtype, float32 or bfloat16
    (the biases, contiguous, cast to it); t [B] int64 contiguous; all on
    q's device; 1 <= Dh <= 256 and H times a head's threads at most 256.
    Returns (B, K, R, H, Dh)."""
    layout_equations(layout)                       # an unknown layout raises
    if q.dim() != 3:
        raise ValueError(f'q must be [B, H, Dh] (got {tuple(q.shape)})')
    B, H, Dh = q.shape
    dt, dev = q.dtype, q.device
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f'q must be float32 or bfloat16 (got {dt})')
    if not 1 <= Dh <= TXL_MAX_DH or H * _head_threads(Dh) > _TXL_GROUP_THREADS:
        raise ValueError(f'unsupported H={H}, Dh={Dh} (1 <= Dh <= '
                         f'{TXL_MAX_DH}, H * threads a head <= '
                         f'{_TXL_GROUP_THREADS})')
    K = cache_positions(k_cache, layout)
    want = {'khd': (B, K, H, Dh), 'hkd': (B, H, K, Dh),
            'dk': (B, H, Dh, K)}[layout]
    R = r_heads.shape[0] if layout == 'khd' else r_heads.shape[-1]
    r_want = (R, H, Dh) if layout == 'khd' else (H, Dh, R)
    checks = [('k_new', k_new, (B, H, Dh)), ('v_new', v_new, (B, H, Dh)),
              ('k_cache', k_cache, want), ('v_cache', v_cache, want),
              ('r_heads', r_heads, r_want)]
    for name, x, shape in checks:
        if x.dtype != dt or x.device != dev or tuple(x.shape) != shape:
            raise ValueError(f'{name}: {x.dtype} {tuple(x.shape)} on '
                             f'{x.device}; expected {dt} {shape} on {dev}')
    for name, x in (('q', q), ('k_new', k_new), ('v_new', v_new)):
        if x.stride(2) != 1 or (H > 1 and x.stride(1) != Dh):
            raise ValueError(f'{name} must hold each row [H, Dh] contiguous '
                             f'(strides {x.stride()})')
    if v_cache.stride() != k_cache.stride():
        raise ValueError(f'k_cache and v_cache strides differ '
                         f'({k_cache.stride()}, {v_cache.stride()})')
    if R < K:
        raise ValueError(f'the relative heads need at least Kmax={K} '
                         f'distance rows (got {R})')
    for name, x in (('r_w_bias', r_w_bias), ('r_r_bias', r_r_bias)):
        if (tuple(x.shape) != (H, Dh) or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f'{name}: {tuple(x.shape)} on {x.device}; '
                             f'expected contiguous {(H, Dh)} on {dev}')
    if (t.dtype != torch.int64 or tuple(t.shape) != (B,) or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f't: {t.dtype} {tuple(t.shape)} on {t.device}; '
                         f'expected contiguous int64 {(B,)} on {dev}')
    return B, K, R, H, Dh


_TXL_SIGNATURES = {
    # (pointers: q k_new v_new r_w r_r k v r t out part cnt; int64 dims and
    #  strides; bf16; scale; stream)
    'txl_decode_attn': [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_float, ctypes.c_void_p],
}
# Host work a call repeats is done once per (stream, layout, and the
# shape, strides, dtype and device of every input): the checks, the
# launch's dims and strides, and the scratch.  A bounded cache.
_CACHE_LIMIT = 256
_txl_plans: Dict[tuple, tuple] = {}


def _txl_plan(args, layout, stream):
    """(dims and strides as the C entry point takes them, the scratch and
    its zeroed counters, B, H, Dh) of checked inputs ``args`` (q, k_new,
    v_new, k_cache, v_cache, t, r_heads, r_w_bias, r_r_bias) in ``layout``,
    launched on ``stream``.  A slot's rows are split over S blocks: about
    TXL_BLOCKS_PER_SM blocks per SM over the batch, at least TXL_MIN_ROWS
    cache rows a block."""
    key = (stream, layout) + tuple((x.shape, x.stride(), x.dtype, x.device)
                                   for x in args)
    plan = _txl_plans.get(key)
    if plan is None:
        q, k_new, v_new, k_cache, _, _, r_heads = args[:7]
        B, K, R, H, Dh = _check_txl_inputs(*args, layout)
        dev = q.device
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        S = max(1, min(-(-TXL_BLOCKS_PER_SM * sms // B), -(-K // TXL_MIN_ROWS)))
        ks, rs = k_cache.stride(), r_heads.stride()
        kv = {'khd': (ks[0], ks[1], ks[2], ks[3]),        # b, k, h, d
              'hkd': (ks[0], ks[2], ks[1], ks[3]),
              'dk': (ks[0], ks[3], ks[1], ks[2])}[layout]
        rr = rs if layout == 'khd' else (rs[2], rs[0], rs[1])   # dist, h, d
        dims = (ctypes.c_longlong * 16)(B, K, R, H, Dh, S, q.stride(0),
                                        k_new.stride(0), v_new.stride(0),
                                        *kv, *rr)
        part = torch.empty(B * S * H * (Dh + 2), dtype=torch.float32,
                           device=dev)
        cnt = torch.zeros(B, dtype=torch.int32, device=dev)
        if len(_txl_plans) >= _CACHE_LIMIT:
            _txl_plans.clear()
        plan = _txl_plans[key] = (dims, part, cnt, B, H, Dh)
    return plan


def _txl_decode_attention_cuda(q, k_new, v_new, k_cache, v_cache, t, r_heads,
                               r_w_bias, r_r_bias, *, scale, layout):
    """Launch ``txl_decode_attn`` (checks, scratch, launch)."""
    if q.device.type != 'cuda':
        raise ValueError(f'the CUDA kernel takes CUDA tensors (got {q.device})')
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dims, part, cnt, B, H, Dh = _txl_plan(
        (q, k_new, v_new, k_cache, v_cache, t, r_heads, r_w_bias, r_r_bias),
        layout, stream)
    r_w = r_w_bias if r_w_bias.dtype == q.dtype else r_w_bias.to(q.dtype)
    r_r = r_r_bias if r_r_bias.dtype == q.dtype else r_r_bias.to(q.dtype)
    out = torch.empty((B, H, Dh), dtype=q.dtype, device=q.device)
    ptrs = (ctypes.c_void_p * 12)(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), r_w.data_ptr(),
        r_r.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        r_heads.data_ptr(), t.data_ptr(), out.data_ptr(), part.data_ptr(),
        cnt.data_ptr())
    lib = _build.library('txl_decode_attn', _TXL_SIGNATURES)
    # The profiler links a kernel to the innermost operator-scope range open
    # at its launch; a span (``utils.profiling``) is a user-scope range,
    # which it does not link.  This range (free without a profiler) gives
    # the launch one, so its device time counts inside the span around the
    # call, as a PyTorch operator's does.
    with _RecordFunctionFast('txl_decode_attn'):
        err = lib.txl_decode_attn(ptrs, dims, int(q.dtype == torch.bfloat16),
                                  scale, stream)
    _build.check(lib, err, 'txl_decode_attn')
    _build.LAUNCHES['txl_decode_attn'] += 1
    return out


def txl_decode_attention_pe(
    q: torch.Tensor,              # [B, H, Dh]
    k_new: torch.Tensor,          # [B, H, Dh]
    v_new: torch.Tensor,          # [B, H, Dh]
    k_cache: torch.Tensor,        # a layer's cache in ``layout``
    v_cache: torch.Tensor,        # like k_cache
    t: torch.Tensor,              # [B] per-element positions, >= 0
    r_heads: torch.Tensor,        # [R, H, Dh] ('khd') or [H, Dh, R]
    r_w_bias: torch.Tensor,       # [H, Dh]
    r_r_bias: torch.Tensor,       # [H, Dh]
    *,
    scale: float,
    layout: str = 'khd',
) -> torch.Tensor:
    """One Transformer-XL layer's cache work in a decode step with a clock
    per element: ``k_new`` / ``v_new`` land at each element's row
    ``clamp(t, 0, K - 1)`` of the caches, **in place**, and the result is
    ``full_decode_attention_pe(q + r_w_bias, ..., rel=(q + r_r_bias,
    r_heads))`` over the written caches, [B, H, Dh] in q's dtype.

    CPU tensors run that plain composition; CUDA tensors launch
    ``txl_decode_attn`` (module docstring) or raise (``_check_txl_inputs``),
    one launch counted in ``_build.LAUNCHES['txl_decode_attn']``."""
    if q.device.type == 'cpu':
        write_row_pe(k_cache, k_new, t, layout)
        write_row_pe(v_cache, v_new, t, layout)
        return full_decode_attention_pe(
            q + r_w_bias.to(q.dtype), k_cache, v_cache, t, scale=scale,
            rel=(q + r_r_bias.to(q.dtype), r_heads), layout=layout)
    return _txl_decode_attention_cuda(q, k_new, v_new, k_cache, v_cache, t,
                                      r_heads, r_w_bias, r_r_bias,
                                      scale=scale, layout=layout)
