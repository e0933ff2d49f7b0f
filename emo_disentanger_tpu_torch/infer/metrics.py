"""Objective metrics over generated event streams (copy of
``emo_disentanger_tpu/infer/metrics.py``).

The reference repo ships no evaluation code (the paper's evaluation is
subjective listening + external emotion classifiers).  These metrics cover
the objective correlates the two-stage design manipulates: valence via key
mode and scale consistency, arousal via note density / velocity / tempo, and
general musical coherence via groove consistency and pitch range.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.theory import MAJOR_KEY, MINOR_KEY, KEY_TO_IDX, degree2pitch

MAJOR_SCALE = [0, 2, 4, 5, 7, 9, 11]
MINOR_SCALE = [0, 2, 3, 5, 7, 8, 10]


def _abs_pitches(events: List[str], key: str) -> List[int]:
    """Absolute MIDI pitches from either note representation: absolute
    ``Note_Pitch_<n>`` events, or the functional ``Note_Octave_<o>`` +
    ``Note_Degree_<roman>`` pairs (stage-2 / lead-sheet layouts), which
    reconstruct through :func:`~..core.theory.degree2pitch` in the
    stream's key."""
    pitches = [int(e.split('_')[-1]) for e in events
               if e.startswith('Note_Pitch')]
    octave = None
    for ev in events:
        if ev.startswith('Note_Octave'):
            octave = int(ev.split('_')[-1])
        elif ev.startswith('Note_Degree') and octave is not None:
            try:
                pitches.append(degree2pitch(key, octave, ev.split('_')[-1]))
            except KeyError:      # malformed roman from a random stream
                pass
    return pitches


def _split_bars(events: List[str]) -> List[List[str]]:
    bars: List[List[str]] = []
    cur: Optional[List[str]] = None
    for ev in events:
        if ev == 'Bar_None':
            if cur is not None:
                bars.append(cur)
            cur = []
        elif cur is not None:
            cur.append(ev)
    if cur:
        bars.append(cur)
    return bars


def find_key(events: List[str]) -> Optional[str]:
    key = None
    for ev in events:
        if ev.startswith('Key_'):
            key = ev.split('_')[1]
    return key


def scale_consistency(events: List[str], key: Optional[str] = None) -> float:
    """Fraction of notes on the key's diatonic scale (either note
    representation, see :func:`_abs_pitches`)."""
    key = key or find_key(events) or 'C'
    if key in MAJOR_KEY:
        tonic, scale = KEY_TO_IDX[key], MAJOR_SCALE
    else:
        tonic, scale = KEY_TO_IDX[key.upper()], MINOR_SCALE
    degrees = {(tonic + s) % 12 for s in scale}
    pitches = _abs_pitches(events, key)
    if not pitches:
        return 0.0
    return float(np.mean([(p % 12) in degrees for p in pitches]))


def note_density(events: List[str]) -> float:
    """Mean notes per bar."""
    bars = _split_bars(events)
    if not bars:
        return 0.0
    counts = [sum(1 for e in bar
                  if e.startswith('Note_Pitch') or e.startswith('Note_Degree'))
              for bar in bars]
    return float(np.mean(counts))


def mean_velocity(events: List[str]) -> float:
    vals = [int(e.split('_')[-1]) for e in events
            if e.startswith('Note_Velocity')]
    return float(np.mean(vals)) if vals else 0.0


def mean_tempo(events: List[str]) -> float:
    vals = [int(e.split('_')[-1]) for e in events
            if e.startswith('Tempo') and 'Conti' not in e]
    return float(np.mean(vals)) if vals else 0.0


def pitch_range(events: List[str], key: Optional[str] = None) -> int:
    pitches = _abs_pitches(events, key or find_key(events) or 'C')
    return int(max(pitches) - min(pitches)) if pitches else 0


def groove_consistency(events: List[str]) -> float:
    """Mean pairwise similarity of adjacent bars' 16-slot onset grids
    (1 - normalized Hamming distance)."""
    bars = _split_bars(events)
    grids = []
    for bar in bars:
        grid = np.zeros(16, dtype=bool)
        for ev in bar:
            if ev.startswith('Beat_'):
                grid[int(ev.split('_')[1])] = True
        grids.append(grid)
    if len(grids) < 2:
        return 1.0
    sims = [1.0 - np.mean(a != b) for a, b in zip(grids[:-1], grids[1:])]
    return float(np.mean(sims))


def mode_label(events: List[str]) -> Optional[str]:
    key = find_key(events)
    if key is None:
        return None
    return 'major' if key in MAJOR_KEY else 'minor'


def emotion_profile(events: List[str]) -> Dict[str, float]:
    """All objective correlates in one dict."""
    return {
        'mode': mode_label(events),
        'scale_consistency': scale_consistency(events),
        'note_density': note_density(events),
        'mean_velocity': mean_velocity(events),
        'mean_tempo': mean_tempo(events),
        'pitch_range': pitch_range(events),
        'groove_consistency': groove_consistency(events),
        'n_bars': float(sum(1 for e in events if e == 'Bar_None')),
        'n_events': float(len(events)),
    }
