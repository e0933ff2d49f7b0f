"""Stage-2 training dataset: a pure-numpy batch producer (port of the stage-2
part of ``emo_disentanger_tpu/data/datasets.py``).

Parity with ``REMISkylineToMidiTransformerDataset``
(``stage2_accompaniment/dataloader.py:42-231``).  The same
``np.random.RandomState(seed)`` draws as the JAX package give the same start
bars and the same shuffles, so both produce identical batches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from glob import glob
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.vocab import Vocab, event_str
from ..utils.io import pickle_load


def _event_type(ev: str) -> str:
    return ev.split('_')[0]


def make_stage2_target(inp: np.ndarray, full_starts: np.ndarray,
                       full_ends: np.ndarray, pad_id: int, eos_id: int,
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Stage-2 target and track mask from offset-adjusted full-track spans:
    the target is PAD outside the Full spans and the next token inside,
    with EOS at the last full position; the mask is 1 on the Full spans.
    A numpy copy of the JAX package's CPU helper
    (``native/__init__.py:98``)."""
    inp = np.ascontiguousarray(inp, dtype=np.int32)
    n = len(inp)
    tgt = np.full(n, pad_id, dtype=np.int32)
    mask = np.zeros(n, dtype=np.int32)
    n_bars = len(full_starts)
    for b in range(n_bars):
        f0, f1 = int(full_starts[b]), int(full_ends[b])
        if f0 >= n:
            break
        mask[f0:min(f1, n)] = 1
        if b != n_bars - 1:
            hi = min(f1, n - 1)
            tgt[f0:hi] = inp[f0 + 1:hi + 1]
        else:
            hi = min(f1 - 1, n - 1)
            tgt[f0:hi] = inp[f0 + 1:hi + 1]
            if 0 <= f1 - 1 < n:
                tgt[f1 - 1] = eos_id
    return tgt, mask


@dataclass
class Stage2Sample:
    dec_inp: np.ndarray      # [L]
    dec_tgt: np.ndarray      # [L]  (PAD outside Full-track spans)
    track_mask: np.ndarray   # [L]  0 = lead sheet, 1 = full track
    length: int
    chord_idx: np.ndarray
    melody_idx: np.ndarray
    piece_id: str


class Stage2Dataset:
    """Bar-interleaved lead-sheet -> full-performance dataset: pieces longer
    than ``model_dec_seqlen`` sample a start bar from the admissible set
    (suffix >= 0.5 x seqlen); the target is PAD everywhere except the
    Full-track spans, with the final Full position re-targeted to EOS; the
    ``track_mask`` (segment ids) marks lead-sheet vs full-track tokens."""

    def __init__(self, data_dir: str, vocab: Vocab, *,
                 pieces: Optional[Sequence[str]] = None,
                 model_dec_seqlen: int = 3072,
                 appoint_st_bar: Optional[int] = None,
                 seed: int = 0):
        self.vocab = vocab
        self.pad_id = vocab.pad_id
        self.eos_id = vocab.eos_id
        self.model_dec_seqlen = model_dec_seqlen
        self.appoint_st_bar = appoint_st_bar
        self.rng = np.random.RandomState(seed)

        if pieces:
            self.paths = sorted(os.path.join(data_dir, p) for p in pieces)
        else:
            self.paths = sorted(glob(os.path.join(data_dir, '*.pkl')))

        self.piece_lead_pos: List[List[Tuple[int, int]]] = []
        self.piece_full_pos: List[List[Tuple[int, int]]] = []
        self.piece_events: List[List[str]] = []
        self.admissible_st_bars: List[List[int]] = []

        for path in self.paths:
            lead_pos, full_pos, evs = pickle_load(path)
            lead_pos, full_pos = list(lead_pos), list(full_pos)
            evs = [event_str(e) for e in evs]
            self.piece_lead_pos.append(lead_pos)
            self.piece_full_pos.append(full_pos)
            self.piece_events.append(evs)

            if len(evs) <= self.model_dec_seqlen:
                self.admissible_st_bars.append([0])
            else:
                ok: List[int] = []
                for bar in range(len(lead_pos)):
                    if len(evs) - lead_pos[bar][0] >= 0.5 * self.model_dec_seqlen:
                        ok.append(bar)
                    else:
                        break
                self.admissible_st_bars.append(ok or [0])

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Stage2Sample:
        evs = self.piece_events[idx]
        lead_pos = self.piece_lead_pos[idx]
        full_pos = self.piece_full_pos[idx]
        if self.appoint_st_bar is not None:
            st_bar = self.appoint_st_bar
        else:
            st_bar = int(self.rng.choice(self.admissible_st_bars[idx]))

        # prefix (Emotion/[Key]/Tempo) + events from the start bar onward
        prefix = evs[:lead_pos[0][0]]
        tokens = self.vocab.encode(prefix + evs[lead_pos[st_bar][0]:])
        length = len(tokens)

        if length < self.model_dec_seqlen:
            tokens = tokens + [self.pad_id] * (self.model_dec_seqlen - length)
        inp = np.asarray(tokens, dtype=np.int32)

        offset = -lead_pos[st_bar][0] + lead_pos[0][0]
        spans = np.asarray([(full_pos[b][0] + offset, full_pos[b][1] + offset)
                            for b in range(st_bar, len(lead_pos))], dtype=np.int64)
        tgt, track_mask = make_stage2_target(inp, spans[:, 0], spans[:, 1],
                                             self.pad_id, self.eos_id)

        tgt_types = [_event_type(e) for e in self.vocab.decode(tgt)]
        chord_idx = np.zeros_like(tgt)
        melody_idx = np.zeros_like(tgt)
        for i, t in enumerate(tgt_types):
            if t == 'Chord':
                chord_idx[i] = 1
            elif t == 'Note':
                melody_idx[i] = 1

        L = self.model_dec_seqlen
        return Stage2Sample(
            dec_inp=inp[:L], dec_tgt=tgt[:L], track_mask=track_mask[:L],
            length=min(length, L), chord_idx=chord_idx[:L],
            melody_idx=melody_idx[:L],
            piece_id=os.path.basename(self.paths[idx]).replace('.pkl', ''))

    def batches(self, batch_size: int, shuffle: bool = True,
                drop_last: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idxs = order[i:i + batch_size]
            if drop_last and len(idxs) < batch_size:
                break
            samples = [self[int(j)] for j in idxs]
            yield {
                'dec_inp': np.stack([s.dec_inp for s in samples]),
                'dec_tgt': np.stack([s.dec_tgt for s in samples]),
                'track_mask': np.stack([s.track_mask for s in samples]),
                'length': np.asarray([s.length for s in samples], dtype=np.int32),
                'chord_idx': np.stack([s.chord_idx for s in samples]),
                'melody_idx': np.stack([s.melody_idx for s in samples]),
            }
