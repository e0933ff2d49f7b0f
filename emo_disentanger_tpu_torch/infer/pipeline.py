"""Stage-1 <-> stage-2 glue: text event files and string-level conversions
(copy of ``emo_disentanger_tpu/infer/pipeline.py``).

The two stages couple via ``.txt``/``_roman.txt`` event files on disk
(stage-2 globs stage-1's output dir, ``stage2_accompaniment/inference.py:
422-428``); these helpers reproduce that contract.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.theory import (
    MAJOR_KEY, ROMAN_TO_MAJOR_DEGREE, ROMAN_TO_MINOR_DEGREE, degree2pitch,
)


def roman_events_to_absolute(key: str, events: List[str]) -> List[str]:
    """Functional event strings -> absolute (REMI-style) strings.

    Octave/Degree pairs become Note_Pitch (clamped to 21..108); Roman chord
    roots become numeric degrees.  Reference:
    ``stage1_compose/inference.py:44-72`` /
    ``stage2_accompaniment/inference.py:173-200``.
    """
    keyname = key.split('_')[1] if '_' in key else key
    out: List[str] = []
    octave: Optional[int] = None
    for ev in events:
        if ev.startswith('Note_Octave'):
            octave = int(ev.split('_')[2])
        elif ev.startswith('Note_Degree'):
            roman = ev.split('_')[2]
            if octave is None:
                # degenerate stream (Degree before any Octave): the reference
                # would crash on an unbound variable; default to mid octave
                octave = 5
            pitch = degree2pitch(keyname, octave, roman)
            pitch = min(108, max(21, pitch))
            out.append('Note_Pitch_{}'.format(pitch))
        elif ev.startswith('Chord_'):
            if 'None' in ev or 'Conti' in ev:
                out.append(ev)
            else:
                parts = ev.split('_')
                root, quality = parts[1], parts[2]
                table = ROMAN_TO_MAJOR_DEGREE if keyname in MAJOR_KEY \
                    else ROMAN_TO_MINOR_DEGREE
                out.append('Chord_{}_{}'.format(table[root], quality))
        else:
            out.append(ev)
    return out


def events_to_txt(events: List[str], path: str) -> None:
    with open(path, 'w') as f:
        f.write('\n'.join(str(e) for e in events) + '\n')


def read_generated_events(path: str, event2idx: Dict[str, int],
                          ) -> Tuple[str, List[List[int]]]:
    """Stage-1 event file -> (key token, per-bar token-id lists).

    Reference: ``stage2_accompaniment/inference.py:149-166``.
    """
    with open(path) as f:
        events = f.read().splitlines()
    events = [e for e in events if e]
    key = events[0] if events and 'Key' in events[0] else 'Key_C'

    if key not in event2idx:
        # a key the stage-2 corpus never saw: the reference would KeyError
        # here (dset.event2idx[key], inference.py:460); degrade to C instead
        print('[warn] {} not in stage-2 vocab; substituting Key_C'.format(key))
        key = 'Key_C'

    bar_pos = [i for i, e in enumerate(events) if e == 'Bar_None']
    bar_pos.append(len(events))
    bars = [events[bar_pos[b]:bar_pos[b + 1]] for b in range(len(bar_pos) - 1)]
    return key, [[event2idx[e] for e in bar] for bar in bars]


def extract_midi_events_from_generation(key: str, events: List[str],
                                        relative_melody: bool = False,
                                        ) -> List[List[str]]:
    """Slice a stage-2 stream into per-bar Full-track event lists
    (reference ``stage2_accompaniment/inference.py:173-210``)."""
    if relative_melody:
        events = roman_events_to_absolute(key, events)

    arr = np.array(events)
    lead_starts = np.where(arr == 'Track_LeadSheet')[0].tolist()
    full_starts = np.where(arr == 'Track_Full')[0].tolist()

    midi_bars: List[List[str]] = []
    for st, ed in zip(full_starts, lead_starts[1:] + [len(events)]):
        midi_bars.append(events[st + 1:ed])
    return midi_bars


def merge_tracks(melody_track: List[str], chord_track: List[str]) -> List[str]:
    """Merge separate melody/chord per-bar tracks beat-wise
    (reference ``stage2_accompaniment/inference.py:106-146``)."""
    events = melody_track[1:3]

    def collect(track: List[str], start: int) -> Dict[str, List[str]]:
        beats: Dict[str, List[str]] = defaultdict(list)
        if len(track) > start:
            seq: List[str] = []
            beat = track[start]
            for ev in track[start + 1:]:
                if 'Beat' in ev:
                    beats[beat] = seq
                    seq = []
                    beat = ev
                else:
                    seq.append(ev)
            beats[beat] = seq
        return beats

    melody_beat = collect(melody_track, 3)
    chord_beat = collect(chord_track, 2)

    for b in range(16):
        beat = 'Beat_{}'.format(b)
        if beat in chord_beat or beat in melody_beat:
            events.append(beat)
            events.extend(chord_beat.get(beat, []))
            events.extend(melody_beat.get(beat, []))
    return events


def construct_inadmissible_set(tempo_val: int, event2idx: Dict[str, int],
                               vocab_size: int, tolerance: int = 20) -> np.ndarray:
    """Bool mask [V] forbidding tempo tokens more than ``tolerance`` bpm from
    ``tempo_val`` (reference ``construct_inadmissible_set``,
    ``stage2_accompaniment/inference.py:59-68``); feed to the samplers'
    ``forbid`` argument."""
    forbid = np.zeros(vocab_size, dtype=bool)
    for ev, idx in event2idx.items():
        if ev.startswith('Tempo') and 'Conti' not in ev:
            if abs(int(ev.split('_')[-1]) - tempo_val) > tolerance:
                forbid[idx] = True
    return forbid


def emotion_candidates_for_file(filename: str) -> List[str]:
    """Valence-labelled stage-1 file -> arousal quadrants to render
    (reference ``stage2_accompaniment/inference.py:433-448``)."""
    base = os.path.basename(filename)
    if 'Positive' in base:
        return ['Q1', 'Q4']
    if 'Negative' in base:
        return ['Q2', 'Q3']
    for q in ('Q1', 'Q2', 'Q3', 'Q4'):
        if q in base:
            return [q]
    if 'None' in base:
        return ['None']
    raise ValueError('wrong emotion label in {}'.format(filename))
