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

Cache layouts (a layer's cache; the model's caches add a leading n_layer):

* ``'khd'`` [B, K, H, Dh], the position heads r_heads [K, H, Dh];
* ``'hkd'`` [B, H, K, Dh] and ``'dk'`` [B, H, Dh, K], both with r_heads
  [H, Dh, K].

The head-major layouts make each (b, h) a matrix at one batch stride, so
the scores and the value product are batched matrix products that read
the cache where it lies, also through a leading view along K (the cache
ladder's tiers); a 'khd' cache must first be copied into that form.  All
three give the same function up to the order of the sums.

Scores and the value product run as einsums in the cache's dtype; the
softmax (and the flash recurrence) runs in float32, and the probabilities
round to the cache's dtype before the value product, as in JAX.  None of
these is a Pallas kernel in the JAX package, so the port keeps them as
PyTorch operations.  JAX's ``EMODIS_PE_WRITE_IMPL`` and
``EMODIS_PE_REL_IMPL`` pick lowerings of the same write and relative term
(tested identical there); the port has one of each: an in-place indexed
store, and the 'slice' form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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
