"""Training datasets: pure-numpy batch producers (port of
``emo_disentanger_tpu/data/datasets.py``).

* ``Stage1Dataset``: lead-sheet (or one-stage full-song) pieces, parity
  with ``SkylineFullSongTransformerDataset``
  (``stage1_compose/dataloader.py:159-520``);
* ``Stage2Dataset``: lead-sheet -> full-performance pieces, parity with
  ``REMISkylineToMidiTransformerDataset``
  (``stage2_accompaniment/dataloader.py:42-231``).

The same ``np.random.RandomState(seed)`` draws as the JAX package give the
same key augmentations, start bars and shuffles, so both produce identical
batches.  While a profiler records, ``Stage2Dataset.batches`` marks the
building of each batch with the span ``emodis.data.batch``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from glob import glob
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.vocab import MAJOR_KEY, MINOR_KEY, Vocab, event_str
from ..utils.io import pickle_load
from ..utils.profiling import span


def _event_type(ev: str) -> str:
    return ev.split('_')[0]


# ---------------------------------------------------------------------------
# stage 1: lead-sheet / one-stage full-song dataset
# ---------------------------------------------------------------------------

@dataclass
class Stage1Sample:
    dec_inp: np.ndarray      # [L] int32, padded
    dec_tgt: np.ndarray      # [L] int32, padded
    length: int
    inp_chord: np.ndarray    # [L] 1 where target is a Chord event
    inp_melody: np.ndarray   # [L] 1 where target is a Note event
    piece_id: str


class Stage1Dataset:
    """Lead-sheet (or one-stage full-song) piece dataset
    (``datasets.py:55-250``): trailing-empty-bar trimming, the 192-bar cap,
    single-segment truncation at ``model_dec_seqlen`` and the reference's
    segment index arithmetic.  The end index is ``bar_pos[last] -
    bar_pos[0] + 1``, shifted left by the Emotion/[Key] prefix length, which
    in the functional representation cuts the sequence one token before EOS
    (``stage1_compose/dataloader.py:484-494``); kept, since the published
    finetune losses depend on it.  ``max_n_seg`` > 1 registers the
    remainder of a long piece as a second segment, trained with XL memory
    recurrence (``segment_batches``)."""

    def __init__(self, data_dir: str, vocab: Vocab, *,
                 pieces: Optional[Sequence[str]] = None,
                 model_dec_seqlen: int = 2400,
                 model_max_bars: int = 192,
                 do_augment: bool = False,
                 max_n_seg: int = 1,
                 seed: int = 0):
        self.vocab = vocab
        self.pad_id = vocab.pad_id
        self.model_dec_seqlen = model_dec_seqlen
        self.model_max_bars = model_max_bars
        self.do_augment = do_augment
        self.max_n_seg = max_n_seg
        self.rng = np.random.RandomState(seed)

        if pieces:
            paths = [os.path.join(data_dir, p) for p in pieces]
            self.paths = sorted(p for p in paths if os.path.exists(p))
        else:
            self.paths = sorted(glob(os.path.join(data_dir, '*.pkl')))

        self.piece_bar_pos: List[List[int]] = []
        self.piece_events: List[List[str]] = []
        for path in self.paths:
            bar_pos, evs = pickle_load(path)
            bar_pos = list(bar_pos)
            evs = list(evs)
            if bar_pos[-1] == len(evs):          # stray trailing marker
                bar_pos = bar_pos[:-1]
            if len(evs[bar_pos[-1]:]) == 2:       # trailing empty bar
                evs = evs[:bar_pos[-1]]
                bar_pos = bar_pos[:-1]
            if len(bar_pos) <= self.model_max_bars:
                bar_pos.append(len(evs) - 1)      # points at EOS
            else:
                bar_pos = bar_pos[:self.model_max_bars + 1]
            self.piece_bar_pos.append(bar_pos)
            self.piece_events.append([event_str(e) for e in evs])

        # segment registration (reference ``register_segments``,
        # ``dataloader.py:386-406``): a first segment cut at the sequence
        # budget and, when max_n_seg > 1, the remainder as a second one
        self.piece_segments: List[List[Tuple[int, int]]] = []
        for bar_pos in self.piece_bar_pos:
            segs: List[Tuple[int, int]] = []
            st_bar = 0
            for b in range(len(bar_pos) - 1):
                if bar_pos[b + 1] - bar_pos[st_bar] > self.model_dec_seqlen - 1:
                    if b > st_bar:
                        segs.append((st_bar, b))
                        st_bar = b
                        break
            if len(segs) < self.max_n_seg:
                segs.append((st_bar, len(bar_pos) - 1))
            self.piece_segments.append(segs)

    def __len__(self) -> int:
        return len(self.paths)

    def _key_augment(self, events: List[str]) -> List[str]:
        """Random same-mode key substitution (``dataloader.py:458-467``)."""
        if _event_type(events[1]) != 'Key':
            raise ValueError('wrong key event')
        keyname = events[1].split('_')[1]
        pool = MAJOR_KEY if keyname in MAJOR_KEY else MINOR_KEY
        events = list(events)
        events[1] = 'Key_{}'.format(self.rng.choice(pool))
        return events

    def _piece_tokens(self, idx: int):
        bar_pos = self.piece_bar_pos[idx]
        events = self.piece_events[idx][:bar_pos[-1]]
        # short pieces close with EOS, capped ones with a fresh Bar
        # (``dataloader.py:434-438``; len(bar_pos) counts bars + 1)
        events = events + (['EOS_None'] if len(bar_pos) <= self.model_max_bars
                           else ['Bar_None'])
        if self.do_augment:
            events = self._key_augment(events)
        return events, self.vocab.encode(events)

    def __getitem__(self, idx: int) -> Stage1Sample:
        return self.segments_of(idx)[0]

    def segments_of(self, idx: int) -> List[Stage1Sample]:
        """All registered segments of a piece (reference
        ``get_decoder_input_data``, ``dataloader.py:469-520``; the shared
        offset comes from the first segment's start bar)."""
        events, tokens = self._piece_tokens(idx)
        bar_pos = self.piece_bar_pos[idx]
        segs = self.piece_segments[idx]
        prefix = bar_pos[segs[0][0]]                   # reference sample_st_idx
        return [self._build_sample(idx, events, tokens, bar_pos, st, ed, prefix)
                for st, ed in segs]

    def _build_sample(self, idx, events, tokens, bar_pos, st_bar, ed_bar,
                      prefix) -> Stage1Sample:
        seg_st = bar_pos[st_bar] - prefix
        seg_ed = bar_pos[ed_bar] - prefix + 1
        L = self.model_dec_seqlen
        inp = np.asarray(tokens[seg_st:seg_ed], dtype=np.int32)[:L]
        tgt = np.asarray(tokens[seg_st + 1:seg_ed + 1], dtype=np.int32)[:L]
        tgt_types = [_event_type(e) for e in events[seg_st + 1:seg_ed + 1]][:L]
        if len(inp) != len(tgt):
            raise ValueError(f'segment of piece {idx} has no target for its '
                             'last token')
        length = len(inp)
        chord = np.zeros(L, dtype=np.int32)
        melody = np.zeros(L, dtype=np.int32)
        for i, t in enumerate(tgt_types):
            if t == 'Chord':
                chord[i] = 1
            elif t == 'Note':
                melody[i] = 1
        pad = np.full(L - length, self.pad_id, dtype=np.int32)
        return Stage1Sample(
            dec_inp=np.concatenate([inp, pad]), dec_tgt=np.concatenate([tgt, pad]),
            length=length, inp_chord=chord, inp_melody=melody,
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
                'length': np.asarray([s.length for s in samples], dtype=np.int32),
                'inp_chord': np.stack([s.inp_chord for s in samples]),
                'inp_melody': np.stack([s.inp_melody for s in samples]),
            }

    def segment_batches(self, batch_size: int, shuffle: bool = True,
                        ) -> Iterator[Dict[str, np.ndarray]]:
        """Multi-segment batches for XL-memory training: arrays are
        [B, max_n_seg, L]; absent segments are all PAD with seg_len 0 (the
        reference collate's padding, ``dataloader.py:236-245``)."""
        L = self.model_dec_seqlen
        S = self.max_n_seg
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idxs = order[i:i + batch_size]
            B = len(idxs)
            out = {
                'dec_inp': np.full((B, S, L), self.pad_id, np.int32),
                'dec_tgt': np.full((B, S, L), self.pad_id, np.int32),
                'inp_chord': np.zeros((B, S, L), np.int32),
                'inp_melody': np.zeros((B, S, L), np.int32),
                'seg_len': np.zeros((B, S), np.int32),
            }
            for bi, j in enumerate(idxs):
                for si, smp in enumerate(self.segments_of(int(j))[:S]):
                    out['dec_inp'][bi, si] = smp.dec_inp
                    out['dec_tgt'][bi, si] = smp.dec_tgt
                    out['inp_chord'][bi, si] = smp.inp_chord
                    out['inp_melody'][bi, si] = smp.inp_melody
                    out['seg_len'][bi, si] = smp.length
            yield out


# ---------------------------------------------------------------------------
# stage 2: lead-sheet conditioned performance dataset
# ---------------------------------------------------------------------------


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
            # the span closes before the yield: a suspended generator's wait
            # is the consumer's time, not the loader's
            with span('emodis.data.batch'):
                samples = [self[int(j)] for j in idxs]
                batch = {
                    'dec_inp': np.stack([s.dec_inp for s in samples]),
                    'dec_tgt': np.stack([s.dec_tgt for s in samples]),
                    'track_mask': np.stack([s.track_mask for s in samples]),
                    'length': np.asarray([s.length for s in samples],
                                         dtype=np.int32),
                    'chord_idx': np.stack([s.chord_idx for s in samples]),
                    'melody_idx': np.stack([s.melody_idx for s in samples]),
                }
            yield batch
