"""HookTheory JSON -> lead-sheet events (stage-1 pretraining corpus; port of
``emo_disentanger_tpu/data/hooktheory.py``).

Parity with the reference (``midi2events_hooktheory.py``): filter the
Hooktheory dump to 4/4, single-key clips with melody+harmony; reconstruct a
MIDI (melody at octave 5, velocity 100); simplify chords to the 11 standard
qualities via interval-vector containment (inversions included); repeat
chords per beat; then reuse the shared EMOPIA quantizer + lead-sheet emitter.
"""

from __future__ import annotations

import gzip
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.theory import MAJOR_KEY, IDX_TO_KEY, KEY_TO_IDX
from ..core.quantize import BEAT_RESOL, DEFAULT_TEMPO
from .midi_io import MidiFile, Instrument, Note, Marker, TempoChange, TimeSignature
from .emopia import quantize_to_corpus, corpus_to_leadsheet

SEVENTH = [[4, 3, 3], [4, 3, 4], [3, 4, 3], [3, 3, 3], [3, 3, 4]]
TRIAD = [[4, 3], [3, 4], [3, 3], [4, 4], [2, 5], [5, 2]]
INTERVAL2SYMBOL = {
    '433': '7', '434': 'M7', '343': 'm7', '333': 'o7', '334': '/o7',
    '43': 'M', '34': 'm', '33': 'o', '44': '+', '25': 'sus2', '52': 'sus4',
}

MELODY_OCTAVE = 5   # mean pitch of EMOPIA is ~72
VELOCITY = 100

MAJOR_INTERVALS = '221222'
MINOR_INTERVALS = '212212'


def _intervals_str(intervals: List[int]) -> str:
    return ''.join(str(i) for i in intervals)


def chord_mhot(interval: List[int]) -> np.ndarray:
    """Interval stack -> 12-d pitch-class multi-hot
    (reference ``chord_mhot``, ``midi2events_hooktheory.py:49-55``)."""
    mhot = np.zeros(12, dtype=int)
    for i in np.cumsum([0] + list(interval)):
        mhot[i % 12] = 1
    return mhot


def chord_simplify(interval: List[int], invert: bool = True):
    """Reduce an arbitrary interval stack to one of the 11 standard qualities
    (reference ``chord_simplify``, ``midi2events_hooktheory.py:58-92``).
    Returns the simplified interval list, or False if irreducible."""
    interval = list(interval)
    if interval in SEVENTH + TRIAD:
        return interval

    mhot = chord_mhot(interval)
    if interval[:3] in SEVENTH:
        return interval[:3]
    if invert:
        for c in SEVENTH:
            if (mhot & chord_mhot(c) == chord_mhot(c)).all():
                return c

    if interval[:2] in TRIAD:
        return interval[:2]
    if invert:
        for c in TRIAD:
            if (mhot & chord_mhot(c) == chord_mhot(c)).all():
                return c

    # add a fifth and retry
    mhot[7] = 1
    for c in SEVENTH + TRIAD:
        if (mhot & chord_mhot(c) == chord_mhot(c)).all():
            return c
    return False


def clip_is_usable(clip: dict) -> bool:
    """Filter predicate (reference ``midi2events_hooktheory.py:241-248``)."""
    tags = clip.get('tags', [])
    ann = clip.get('annotations', {})
    meters = ann.get('meters', [])
    keys = ann.get('keys', [])
    return (
        'MELODY' in tags and 'HARMONY' in tags
        and 'METER_CHANGES' not in tags and 'KEY_CHANGES' not in tags
        and bool(meters) and meters[0].get('beats_per_bar') == 4
        and meters[0].get('beat_unit') == 4
        and bool(keys)
        and _intervals_str(keys[0]['scale_degree_intervals']) in (MAJOR_INTERVALS, MINOR_INTERVALS)
    )


def annotation_to_midi(annotations: dict, *, relative_chord: bool = False,
                       transpose_to_C: bool = False) -> MidiFile:
    """Reconstruct a regularized MIDI from a HookTheory annotation
    (reference ``annotation2midi``, ``midi2events_hooktheory.py:95-200``)."""
    midi = MidiFile(ticks_per_beat=BEAT_RESOL)
    midi.time_signature_changes.append(TimeSignature(4, 4, 0))
    midi.instruments.append(Instrument(program=0, is_drum=False, name='piano'))

    key = IDX_TO_KEY[annotations['keys'][0]['tonic_pitch_class']]
    mode = _intervals_str(annotations['keys'][0]['scale_degree_intervals'])
    keyname = key.lower() if mode == MINOR_INTERVALS else key.upper()

    if transpose_to_C:
        tonic = KEY_TO_IDX[key]
        pitch_offset = (12 - tonic) if tonic >= 6 else -tonic
        root2degree = {MAJOR_KEY[i]: str(i) for i in range(12)}
    elif relative_chord:
        pitch_offset = 0
        start = int(np.where(MAJOR_KEY == key)[0][0])
        rotated = np.concatenate([MAJOR_KEY[start:], MAJOR_KEY[:start]])
        root2degree = {rotated[i]: str(i) for i in range(12)}
    else:
        pitch_offset = 0
        root2degree = {MAJOR_KEY[i]: str(i) for i in range(12)}

    midi.markers.append(Marker(text='global_key_' + keyname, time=0))
    midi.tempo_changes.append(TempoChange(tempo=DEFAULT_TEMPO, time=0))
    midi.markers.append(Marker(text='global_bpm_' + str(DEFAULT_TEMPO), time=0))

    for note in annotations['melody']:
        onset = int(note['onset'] * BEAT_RESOL)
        offset = int(note['offset'] * BEAT_RESOL)
        if onset == offset:
            continue
        pitch = note['pitch_class'] + (MELODY_OCTAVE + note['octave']) * 12 + pitch_offset
        midi.instruments[0].notes.append(
            Note(start=onset, end=offset, pitch=pitch, velocity=VELOCITY))

    max_tick = max(n.end for n in midi.instruments[0].notes)
    midi.max_tick = max_tick

    # chords: simplify quality, then repeat per beat
    raw_chords: List[Marker] = []
    for chord in annotations['harmony']:
        onset = int(np.round(chord['onset']) * BEAT_RESOL)
        offset = int(np.round(chord['offset']) * BEAT_RESOL)
        max_tick = max(max_tick, offset)
        if onset == offset:
            continue
        root = IDX_TO_KEY[(chord['root_pitch_class'] + pitch_offset) % 12]
        interval = chord_simplify(chord['root_position_intervals'], invert=True)
        if interval:
            quality = INTERVAL2SYMBOL[_intervals_str(interval)]
            raw_chords.append(Marker(time=onset, text=root + '_' + quality + '_' + root))
        else:
            raw_chords.append(Marker(time=onset, text='None_None_None'))
    raw_chords.sort(key=lambda m: m.time)

    beat2chord = {c.time: c for c in raw_chords}
    prev = 'None_None_None'
    chords: List[Marker] = []
    max_beat = int(np.ceil(max_tick / BEAT_RESOL) * BEAT_RESOL)
    for beat in range(0, max_beat, BEAT_RESOL):
        if beat in beat2chord:
            chords.append(beat2chord[beat])
            prev = beat2chord[beat].text
        else:
            chords.append(Marker(time=beat, text=prev))

    # chord roots -> scale-degree strings
    trans: List[Marker] = []
    for c in chords:
        if 'None' in c.text or 'Conti' in c.text:
            trans.append(c)
            continue
        root, quality, bass = c.text.split('_')
        trans.append(Marker(
            time=c.time,
            text='_'.join([root2degree[root], quality, root2degree[bass]])))
    midi.markers += trans
    midi.max_tick = max_tick
    return midi


def clip_to_leadsheet_events(clip: dict, *, relative_chord: bool,
                             relative_melody: bool,
                             transpose_to_C: bool = False,
                             min_bars: int = 4,
                             ) -> Optional[Tuple[List[int], List[dict]]]:
    """Annotation -> (bar positions, lead-sheet events); None if < min_bars
    (reference drops clips with < 4 bars, ``midi2events_hooktheory.py:289-290``)."""
    midi = annotation_to_midi(clip['annotations'], relative_chord=relative_chord,
                              transpose_to_C=transpose_to_C)
    corpus = quantize_to_corpus(midi)
    pos, events = corpus_to_leadsheet(
        corpus, None, relative_melody=relative_melody, relative_chord=relative_chord)
    if len(pos) < min_bars:
        return None
    return pos, events


def load_hooktheory_json(path: str) -> Dict[str, dict]:
    with gzip.open(path, 'r') as f:
        return json.load(f)


def find_key_hooktheory(dataset: Dict[str, dict]) -> Tuple[Dict[str, str], Dict[str, int]]:
    """clip name -> (key name, mode), skipping non-diatonic modes
    (reference ``find_key_hooktheory``, ``convert_key.py:93-115``)."""
    clip2keyname: Dict[str, str] = {}
    clip2keymode: Dict[str, int] = {}
    for name, v in dataset.items():
        ann = v['annotations']
        key = IDX_TO_KEY[ann['keys'][0]['tonic_pitch_class']]
        mode = _intervals_str(ann['keys'][0]['scale_degree_intervals'])
        if mode == MAJOR_INTERVALS:
            clip2keyname[name], clip2keymode[name] = key.upper(), 0
        elif mode == MINOR_INTERVALS:
            clip2keyname[name], clip2keymode[name] = key.lower(), 1
    return clip2keyname, clip2keymode
