"""The training batches, worked out again from the corpus on disk: the
reference's stage-2 loader (``stage2_accompaniment/dataloader.py``), in
plain numpy.

A piece longer than the sequence starts at a bar drawn from those whose
suffix holds at least half the sequence; the input is the piece's prefix
(emotion, key, tempo) and its events from that bar on, PAD-filled; the
target is PAD outside the full-track spans and the next event inside them,
with EOS at the last full-track position; the segment input marks the
full-track spans.  The draws come from one ``RandomState(seed)`` in the
loader's order: a shuffle of the pieces an epoch, then one start bar a
piece as the batch is built.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List

import numpy as np


def _targets(inp: np.ndarray, spans: List[tuple], pad: int, eos: int):
    n = len(inp)
    tgt = np.full(n, pad, dtype=np.int64)
    seg = np.zeros(n, dtype=np.int64)
    for b, (f0, f1) in enumerate(spans):
        if f0 >= n:
            break
        seg[f0:min(f1, n)] = 1
        last = b == len(spans) - 1
        hi = min(f1 - 1 if last else f1, n - 1)
        tgt[f0:hi] = inp[f0 + 1:hi + 1]
        if last and 0 <= f1 - 1 < n:
            tgt[f1 - 1] = eos
    return tgt, seg


def batches(events_dir: str, names: List[str], e2w: Dict[str, int],
            seq_len: int, batch: int, seed: int) -> Iterator[dict]:
    """Endless batches {'tokens', 'targets', 'seg'} of int64 [batch, L]."""
    pad = len(e2w)
    eos = e2w['EOS_None']
    pieces = []
    for name in sorted(names):
        with open(os.path.join(events_dir, name), 'rb') as f:
            lead, full, evs = pickle.load(f)
        if len(evs) <= seq_len:
            ok = [0]
        else:
            ok = []
            for b in range(len(lead)):
                if len(evs) - lead[b][0] < 0.5 * seq_len:
                    break
                ok.append(b)
            ok = ok or [0]
        pieces.append((list(lead), list(full), [e2w[e] for e in evs], ok))
    rng = np.random.RandomState(seed)
    while True:
        order = np.arange(len(pieces))
        rng.shuffle(order)
        for i in range(0, len(order), batch):
            rows = []
            for j in order[i:i + batch]:
                lead, full, ids, ok = pieces[int(j)]
                st = int(rng.choice(ok))
                toks = ids[:lead[0][0]] + ids[lead[st][0]:]
                toks = toks + [pad] * (seq_len - len(toks))
                inp = np.asarray(toks, dtype=np.int64)
                off = lead[0][0] - lead[st][0]
                spans = [(full[b][0] + off, full[b][1] + off)
                         for b in range(st, len(lead))]
                tgt, seg = _targets(inp, spans, pad, eos)
                rows.append((inp[:seq_len], tgt[:seq_len], seg[:seq_len]))
            yield {k: np.stack([r[n] for r in rows])
                   for n, k in enumerate(('tokens', 'targets', 'seg'))}
