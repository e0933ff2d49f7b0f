"""Decode-cache helpers for dense attention.

Port of the 'khd' parts of ``emo_disentanger_tpu/ops/attention.py``: the
einsum equations of a decode step over a cache laid out [B, K, H, Dh], and
the per-element-clock row write.  The JAX package's 'dk' and 'hkd' layouts
are tilings chosen for the TPU's (8, 128) vector registers; the port carries
'khd' only and refuses the others.  The Transformer-XL decode attention of
that file comes with stage 1.
"""

from __future__ import annotations

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
