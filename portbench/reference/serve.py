"""The reference's reading of served songs: each song's stream worked out
into its tokens, segments and the positions the model chose, then the
plain model run once over it.

A stage-2 song is its primer (emotion, key, tempo and Track_LeadSheet,
segment 0), then bar by bar the lead sheet's bar injected (segment 0, its
closing Track_Full segment 1) and the full track the model writes (segment
1, the Track_LeadSheet that closes the bar segment 0), until the lead sheet
runs out.  Only the full-track tokens were chosen by the model.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import models


def song_layout(stream: List[int], primer_len: int, bars: List[List[int]],
                e2w: Dict[str, int]):
    """(segments, chosen) of a stream: ``chosen[i]`` is True where the
    model chose token i.  Raises where an injected token is not the lead
    sheet's (the program wrote a wrong stream)."""
    lead, full = e2w['Track_LeadSheet'], e2w['Track_Full']
    seg = [0] * min(primer_len, len(stream))
    chosen = [False] * len(seg)
    i, bar = primer_len, 0
    while i < len(stream) and bar < len(bars):
        row = bars[bar] + [full]
        for j, tok in enumerate(row):
            if i >= len(stream):
                break
            if stream[i] != tok:
                raise ValueError(f'token {i} is {stream[i]}, the lead sheet '
                                 f'injects {tok}')
            seg.append(1 if j == len(row) - 1 else 0)
            chosen.append(False)
            i += 1
        while i < len(stream):
            tok = stream[i]
            seg.append(0 if tok == lead else 1)
            chosen.append(True)
            i += 1
            if tok == lead:
                break
        bar += 1
    if i < len(stream):
        raise ValueError(f'the stream runs {len(stream) - i} tokens past its '
                         'lead sheet')
    return seg, chosen


@torch.no_grad()
def chosen_gaps(P, cfg: dict, songs: List[dict], e2w: Dict[str, int],
                omegas=None, quant=models._ident, control=False,
                device='cpu') -> np.ndarray:
    """The gap by which each chosen token's logit lies below the best logit
    of the plain float32 model, at every chosen position of ``songs``
    (dicts with 'stream', 'primer_len', 'bars').  With ``quant`` the model
    computes in a lower precision, and with ``control`` the gap is that of
    the token it puts first, still read off the float32 model."""
    gaps = []
    for song in songs:
        stream = song['stream']
        seg, chosen = song_layout(stream, song['primer_len'], song['bars'], e2w)
        tok = torch.tensor([stream], device=device)
        sg = torch.tensor([seg], device=device)
        ref = models.forward(P, cfg, tok, sg, omegas)[0].double()
        pick = tok[0, 1:]
        if control:
            pick = models.forward(P, cfg, tok, sg, omegas, quant=quant)[0].argmax(-1)[:-1]
        at = torch.tensor(chosen[1:], device=device)
        lo = ref[:-1]
        gap = lo.max(-1).values - lo.gather(-1, pick[:, None])[:, 0]
        gaps.append(gap[at].cpu().numpy())
    return np.concatenate(gaps) if gaps else np.zeros(0)
