"""Decode attention over a KV cache for dense attention.

Port of the 'khd' parts of ``emo_disentanger_tpu/ops/attention.py``: the
einsum equations of a decode step over a cache laid out [B, K, H, Dh], the
per-element-clock row write, and the three decode attentions of the stage-1
Transformer-XL, each with the relative-position score term
``BD[j] = rr_q . r_heads[t - j]``:

* ``flash_decode_attention``: the chunked online-softmax decode over the
  live prefix [0, t] only, the relative term per chunk;
* ``full_decode_attention``: the whole padded cache, masked past ``t``;
* ``full_decode_attention_pe``: the same with a per-element clock ``t`` [B]
  (continuous batching).

Scores and the value product run as einsums in the cache's dtype; the
softmax (and the flash recurrence) runs in float32, and the probabilities
round to the cache's dtype before the value product, as in JAX.  None of
these is a Pallas kernel in the JAX package, so the port keeps them as
PyTorch operations.  The JAX package's 'dk' and 'hkd' layouts are tilings
chosen for the TPU's (8, 128) vector registers; the port carries 'khd' only
and refuses the others.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def layout_equations(layout: str):
    """(scores, value) einsum equations for a decode cache in ``layout``:
    q [B, H, Dh] x cache -> scores [B, H, K]; probs [B, H, K] x cache ->
    [B, H, Dh]."""
    if layout != 'khd':
        raise ValueError(f"the port carries the 'khd' cache layout only "
                         f"(got {layout!r})")
    return 'bhd,bjhd->bhj', 'bhj,bjhd->bhd'


def write_row_pe(cache_layer: torch.Tensor, new_row: torch.Tensor,
                 t: torch.Tensor, layout: str = 'khd') -> torch.Tensor:
    """Per-element-clock cache write: ``new_row`` [B, H, Dh] lands at each
    element's own position ``t[b]`` of ``cache_layer`` [B, K, H, Dh],
    **in place**; returns ``cache_layer``.  Positions are clamped to
    [0, K - 1], as JAX's ``dynamic_update_slice`` clamps its start index."""
    layout_equations(layout)
    rows = torch.arange(cache_layer.shape[0], device=cache_layer.device)
    cache_layer[rows, t.clamp(0, cache_layer.shape[1] - 1)] = new_row.to(
        cache_layer.dtype)
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
    k_cache: torch.Tensor,        # [B, Kmax, H, Dh]
    v_cache: torch.Tensor,        # [B, Kmax, H, Dh]
    t: int,                       # one position for every element
    *,
    scale: float,
    rel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """The function of :func:`flash_decode_attention` over the whole padded
    cache, masked past ``t`` (``ops/attention.py:169-232``, 'khd'): the
    distance rows are gathered at ``clip(t - j, 0, R - 1)``."""
    eq_s, eq_v = layout_equations('khd')
    Kmax = k_cache.shape[1]
    t = int(t)
    s = torch.einsum(eq_s, q.to(k_cache.dtype), k_cache).float()
    pos = torch.arange(Kmax, device=q.device)
    if rel is not None:
        rr_q, r_heads = rel
        rsel = r_heads[(t - pos).clamp(0, r_heads.shape[0] - 1)]
        s = s + torch.einsum('bhd,jhd->bhj', rr_q.to(rsel.dtype), rsel).float()
    s = s * scale
    s = torch.where((pos > t)[None, None, :], NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    return torch.einsum(eq_v, p.to(v_cache.dtype), v_cache).to(q.dtype)


def full_decode_attention_pe(
    q: torch.Tensor,              # [B, H, Dh]
    k_cache: torch.Tensor,        # [B, Kmax, H, Dh]
    v_cache: torch.Tensor,        # [B, Kmax, H, Dh]
    t: torch.Tensor,              # [B] per-element positions
    *,
    scale: float,
    rel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """:func:`full_decode_attention` with a per-element clock ``t`` [B]
    (``ops/attention.py:273-351``, JAX's default 'slice' form of the
    relative term): ``rq_all[b, h, d] = rr_q . r_heads[d]`` for every
    distance row, reversed and zero-padded by Kmax - 1, and each element
    reads its window ``bd[b, h, j] = rev[b, h, (R - 1 - t_b) + j]``;
    positions j > t_b read the pad, which the mask kills.  The window start
    is clamped to [0, R - 1] as ``dynamic_slice`` clamps it, so a dead slot
    whose clock ran past the cache still reads in bounds.  Needs
    R >= Kmax."""
    eq_s, eq_v = layout_equations('khd')
    B, Kmax, H, _ = k_cache.shape
    s = torch.einsum(eq_s, q.to(k_cache.dtype), k_cache).float()
    if rel is not None:
        rr_q, r_heads = rel
        R = r_heads.shape[0]
        if R < Kmax:
            raise ValueError(f'the relative heads need at least Kmax={Kmax} '
                             f'distance rows (got {R})')
        rq_all = torch.einsum('bhd,khd->bhk', rr_q.to(r_heads.dtype),
                              r_heads).float()
        rev = torch.nn.functional.pad(rq_all.flip(-1), (0, Kmax - 1))
        start = (R - 1 - t).clamp(0, R - 1)
        windows = rev.unfold(-1, Kmax, 1)              # [B, H, R, Kmax]
        s = s + windows[torch.arange(B, device=t.device), :, start]
    s = s * scale
    masked = torch.arange(Kmax, device=t.device)[None, :] > t[:, None]
    s = torch.where(masked[:, None, :], NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    return torch.einsum(eq_v, p.to(v_cache.dtype), v_cache).to(q.dtype)
