"""The traffic generators: the stage-2 vocabulary, the training corpus and
the generation queue, all drawn from the run's seed.  One general generator
per kind, driven by the parameters in a cell's file.

Copied from the bring-up smoke test's generators (``synthetic_vocab``,
``write_corpus``, ``synthetic_jobs``) so that the yardstick does not move
with the program: the vocabulary is the reference's full functional
stage-2 vocabulary (``events2words.py:31`` ``build_full_vocab``, relative
degrees, with velocities) plus the corpus's special events: 326 events,
and PAD makes 327 tokens.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

DEGREES = ('I', 'II', 'III', 'IV', 'V', 'VI', 'VII')
MAJOR_KEY = ('C', 'C#', 'D', 'D#', 'E', 'F', 'F#', 'G', 'G#', 'A', 'A#', 'B')
MINOR_KEY = ('c', 'c#', 'd', 'd#', 'e', 'f', 'f#', 'g', 'g#', 'a', 'a#', 'b')
# the reference's relative roots: the twelve semitones as major-scale
# degrees, sharpened where no degree falls
CHORD_ROOTS = ('I', 'I#', 'II', 'II#', 'III', 'IV', 'IV#', 'V', 'V#', 'VI',
               'VI#', 'VII')
QUALITIES = ('M', 'm', 'o', '+', '7', 'M7', 'm7', 'o7', '/o7', 'sus2', 'sus4')


def full_vocab() -> List[str]:
    """The reference's full vocabulary, functional (relative) form, with
    emotions, velocities and tempos."""
    ev = [f'Emotion_{e}' for e in ('Q1', 'Q2', 'Q3', 'Q4', None)]
    ev += [f'Chord_{r}_{q}' for r in CHORD_ROOTS for q in QUALITIES]
    ev.append('Chord_None_None')
    ev += [f'Note_Octave_{o}' for o in range(1, 10)]
    ev += [f'Note_Degree_{d}' for d in CHORD_ROOTS]
    ev += [f'Note_Velocity_{int(v)}' for v in np.linspace(4, 127, 42, dtype=int)]
    ev += [f'Note_Duration_{d}' for d in range(120, 1920 + 120, 120)]
    ev += [f'Tempo_{int(t)}' for t in np.linspace(32, 224, 65, dtype=int)]
    return ev


def dictionary() -> Tuple[Dict[str, int], Dict[int, str]]:
    """(event2word, word2event): the full vocabulary and the specials the
    stage-2 corpus uses, indexed in sorted order as ``events2words`` does."""
    specials = (['Bar_None', 'EOS_None', 'Track_LeadSheet', 'Track_Full']
                + [f'Beat_{b}' for b in range(16)]
                + [f'Key_{k}' for k in MAJOR_KEY + MINOR_KEY])
    events = sorted(set(specials + full_vocab()))
    return ({e: i for i, e in enumerate(events)},
            {i: e for i, e in enumerate(events)})


def write_corpus(root: str, seed: int, pieces: int, bars: int) -> List[str]:
    """A stage-2 corpus in the pipeline's pickle format under ``root``:
    ``events/<piece>.pkl`` = (lead_pos, full_pos, events), each piece
    ``bars`` bars of an interleaved lead sheet (4 beats a bar) and full
    track (8 beats of two notes), ~104 events a bar.  Returns the piece
    file names."""
    rng = np.random.RandomState(seed)
    e2w, _ = dictionary()
    vels = [ev for ev in e2w if ev.startswith('Note_Velocity_')]
    deg = lambda: DEGREES[rng.randint(7)]
    events_dir = os.path.join(root, 'events')
    os.makedirs(events_dir, exist_ok=True)
    names = []
    for p in range(pieces):
        evs = [f'Emotion_Q{1 + p % 4}', 'Key_C' if p % 2 == 0 else 'Key_a',
               'Tempo_110']
        lead_pos, full_pos = [], []
        for bar in range(bars):
            lead = ['Track_LeadSheet', 'Bar_None']
            for beat in range(0, 16, 4):
                lead += [f'Beat_{beat}', f'Chord_{deg()}_M',
                         f'Note_Octave_{rng.randint(4, 6)}',
                         f'Note_Degree_{deg()}', 'Note_Duration_480']
            if bar == bars - 1:
                lead.append('EOS_None')
            full = ['Track_Full', 'Bar_None']
            for beat in range(0, 16, 2):
                full += [f'Beat_{beat}', f'Chord_{deg()}_M']
                for _ in range(2):
                    full += [f'Note_Octave_{rng.randint(3, 6)}',
                             f'Note_Degree_{deg()}',
                             f'Note_Duration_{120 * rng.randint(1, 9)}',
                             vels[rng.randint(len(vels))]]
            lead_pos.append((len(evs), len(evs) + len(lead)))
            evs += lead
            full_pos.append((len(evs), len(evs) + len(full)))
            evs += full
        names.append(f'Q{1 + p % 4}_piece{p:04d}.pkl')
        with open(os.path.join(events_dir, names[-1]), 'wb') as f:
            pickle.dump((lead_pos, full_pos, evs), f)
    return names


def song_bars(n_jobs: int, lo: int, hi: int, rng: np.random.RandomState,
              same_sizes: bool = False) -> List[int]:
    """Lead-sheet bars of ``n_jobs`` songs: lo, lo + 1, ..., hi in turn, so
    that every seed asks for the same sizes; in an order drawn from ``rng``,
    or with ``same_sizes`` in that order for every seed."""
    bars = [lo + j % (hi - lo + 1) for j in range(n_jobs)]
    return bars if same_sizes else [bars[i] for i in rng.permutation(n_jobs)]


def jobs(e2w: Dict[str, int], n_jobs: int, lo: int, hi: int,
         rng: np.random.RandomState, same_sizes: bool = False):
    """Primers (emotion, key, tempo) and lead sheets: each bar opens with
    Bar_None and holds 2-4 beats of (Beat, Chord, Octave, Degree,
    Duration).  With ``same_sizes`` every seed gets the same songs' lengths
    in the same order (the beats a bar take 2, 3, 4 in turn) and draws
    only their events: a queue's refills and its drain are then the same
    work for every seed."""
    primers, sheets = [], []
    for j, n_bars in enumerate(song_bars(n_jobs, lo, hi, rng, same_sizes)):
        primers.append([e2w[f'Emotion_Q{1 + j % 4}'],
                        e2w['Key_C' if j % 2 == 0 else 'Key_a'],
                        e2w['Tempo_110']])
        sheet = []
        for k in range(n_bars):
            beats = 2 + (j + k) % 3 if same_sizes else rng.randint(2, 5)
            bar = [e2w['Bar_None']]
            for beat in sorted(rng.choice(16, size=beats, replace=False)):
                bar += [e2w[f'Beat_{beat}'],
                        e2w[f'Chord_{DEGREES[rng.randint(7)]}_M'],
                        e2w[f'Note_Octave_{rng.randint(4, 7)}'],
                        e2w[f'Note_Degree_{DEGREES[rng.randint(7)]}'],
                        e2w[f'Note_Duration_{120 * rng.randint(1, 9)}']]
            sheet.append(bar)
        sheets.append(sheet)
    return primers, sheets


# the next events each event allows: a head that follows it makes a random
# model write one note a bar (Beat_0, Octave, Degree, Duration, Velocity)
# and close the bar, so a song's length is set by its lead sheet alone and
# every seed asks for the same work; the model chooses the degree (7) and
# the duration (16), near ties that the check reads
NOTE_GRAMMAR = {
    'Track_Full': ['Beat_0'],
    'Beat_0': ['Note_Octave_5'],
    'Note_Octave_5': [f'Note_Degree_{d}' for d in DEGREES],
    **{f'Note_Degree_{d}': [f'Note_Duration_{120 * k}' for k in range(1, 17)]
       for d in DEGREES},
    **{f'Note_Duration_{120 * k}': ['Note_Velocity_64'] for k in range(1, 17)},
    'Note_Velocity_64': ['Track_LeadSheet'],
}
