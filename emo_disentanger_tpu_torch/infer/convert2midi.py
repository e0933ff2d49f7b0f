"""Generated event stream -> MIDI rendering (copy of
``emo_disentanger_tpu/infer/convert2midi.py``).

Parity with the reference's ``convert2midi.py`` (byte-identical copies in
both stage dirs, differing only in mode strings — unified here into one
``RenderMode`` enum): walks Bar/Beat/Tempo/Note/Chord events into note,
tempo and chord-marker lists, renders chord roots back to absolute letters
via the key's rotated scale, and optionally realizes chords as a second
piano track (bass + triad/7th voicing).
"""

from __future__ import annotations

from enum import Enum
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.theory import MAJOR_KEY, KEY_TO_IDX
from ..core.events import split_event_str
from ..data.midi_io import MidiFile, Instrument, Marker, Note, TempoChange

BEAT_RESOL = 480
BAR_RESOL = BEAT_RESOL * 4
FRACTION = 16
TICK = BAR_RESOL // FRACTION


class RenderMode(str, Enum):
    """Unifies the reference's mode strings: stage-1 uses
    'lead_sheet'/'full_song', stage-2 uses 'skyline'/'full'
    (``stage1_compose/convert2midi.py:178,189`` vs the stage-2 copy)."""
    LEAD_SHEET = 'lead_sheet'
    FULL_SONG = 'full_song'

    @classmethod
    def parse(cls, mode: str) -> 'RenderMode':
        return {'lead_sheet': cls.LEAD_SHEET, 'skyline': cls.LEAD_SHEET,
                'full_song': cls.FULL_SONG, 'full': cls.FULL_SONG}[mode]


# chord quality -> pitch-class offsets (reference chord_maps,
# ``stage2_accompaniment/inference.py:24-49`` and the conversion table in
# ``convert2midi.py:16-51`` reduced to the 11 standard qualities)
CHORD_MAPS = {
    'M': [0, 4, 7], 'm': [0, 3, 7], 'o': [0, 3, 6], '+': [0, 4, 8],
    '7': [0, 4, 7, 10], 'M7': [0, 4, 7, 11], 'm7': [0, 3, 7, 10],
    'o7': [0, 3, 6, 9], '/o7': [0, 3, 6, 10],
    'sus2': [0, 2, 7], 'sus4': [0, 5, 7],
}


class TempoEvent:
    def __init__(self, tempo: int, bar: int, position: int):
        self.tempo = tempo
        self.start_tick = bar * BAR_RESOL + position * TICK


def events_to_midi(key: str, events: Sequence[str], mode: Union[str, RenderMode],
                   output_midi_path: Optional[str] = None,
                   enforce_tempo: bool = False,
                   enforce_tempo_evs: Optional[List[TempoEvent]] = None,
                   play_chords: bool = False,
                   default_velocity: int = 80) -> MidiFile:
    """Render an event-string list to a MidiFile (and optionally write it)."""
    mode = RenderMode.parse(mode if isinstance(mode, str) else mode.value)

    keyname = key.split('_')[1].upper() if '_' in key else key.upper()
    start = int(np.where(MAJOR_KEY == keyname)[0][0])
    scale_range = np.concatenate([MAJOR_KEY[start:], MAJOR_KEY[:start]])

    notes: List[Note] = []
    tempos: List[TempoEvent] = []
    chords: List[Tuple[str, int]] = []          # (value, tick)

    cur_bar, cur_pos = -1, 0
    i = 0
    evs = list(events)
    n = len(evs)
    while i < n:
        name, value = split_event_str(evs[i])
        if name == 'Bar':
            cur_bar += 1
        elif name == 'Beat':
            cur_pos = int(value)
            assert 0 <= cur_pos < FRACTION
        elif name == 'Tempo' and 'Conti' not in str(value):
            tempos.append(TempoEvent(int(value), max(cur_bar, 0), cur_pos))
        elif name == 'Note_Pitch':
            tick = cur_bar * BAR_RESOL + cur_pos * TICK
            if (mode is RenderMode.FULL_SONG and i + 2 < n
                    and evs[i + 1].startswith('Note_Duration')
                    and evs[i + 2].startswith('Note_Velocity')):
                dur = int(evs[i + 1].split('_')[-1])
                vel = int(evs[i + 2].split('_')[-1])
                notes.append(Note(velocity=vel, pitch=int(value),
                                  start=tick, end=tick + dur))
            elif (mode is RenderMode.LEAD_SHEET and i + 1 < n
                    and evs[i + 1].startswith('Note_Duration')):
                dur = int(evs[i + 1].split('_')[-1])
                notes.append(Note(velocity=default_velocity, pitch=int(value),
                                  start=tick, end=tick + dur))
        elif name == 'Chord' and 'Conti' not in str(value):
            chords.append((value, cur_bar * BAR_RESOL + cur_pos * TICK))
        i += 1

    midi = MidiFile(ticks_per_beat=BEAT_RESOL)
    midi.instruments.append(Instrument(program=0, is_drum=False, name='Piano',
                                       notes=notes))

    if not enforce_tempo:
        for t in tempos:
            midi.tempo_changes.append(TempoChange(tempo=t.tempo, time=t.start_tick))
    else:
        for t in (enforce_tempo_evs or tempos[1:2]):
            midi.tempo_changes.append(TempoChange(tempo=t.tempo, time=t.start_tick))

    for value, tick in chords:
        if 'None' in value:
            midi.markers.append(Marker(text='Chord-' + value, time=tick))
        else:
            root, quality = value.split('_')
            label = str(scale_range[int(root)]) + '_' + quality
            midi.markers.append(Marker(text='Chord-' + label, time=tick))
    for b in range(max(cur_bar, 0)):
        midi.markers.append(Marker(text='Bar-{}'.format(b + 1), time=BAR_RESOL * b))

    if notes:
        midi.max_tick = max(n_.end for n_ in notes)

    if play_chords:
        add_chord_track(midi)

    if output_midi_path is not None:
        midi.dump(output_midi_path)
    return midi


def chord_to_pitches(chord: str) -> List[int]:
    """'C_M7' -> MIDI pitches: bass at C2 + voicing rooted at C4
    (reference ``chord_to_midi``, ``convert2midi.py:292-303``)."""
    root, quality = chord.split('_')
    root_pc = KEY_TO_IDX[root]
    offsets = CHORD_MAPS[quality]
    return [36 + root_pc] + [60 + root_pc + o for o in offsets]


def add_chord_track(midi: MidiFile, velocity: int = 63) -> MidiFile:
    """Realize deduplicated chord markers as held notes on a second track
    (reference ``add_chords``, ``convert2midi.py:261-289``)."""
    markers = [m for m in midi.markers if m.text.startswith('Chord-')]
    dedup: List[Marker] = []
    prev = None
    for m in markers:
        if m.text == 'Chord-None_None':
            continue
        if m.text != prev:
            prev = m.text
            dedup.append(m)

    track = Instrument(program=0, is_drum=False, name='Piano')
    midi.instruments.append(track)
    if not dedup:
        return midi

    pitch_sets = [chord_to_pitches(m.text.split('-', 1)[1]) for m in dedup]
    spans = list(zip(dedup, dedup[1:] + [None]))
    for (marker, nxt), pitches in zip(spans, pitch_sets):
        end = nxt.time if nxt is not None else midi.max_tick
        for p in pitches:
            track.notes.append(Note(velocity=velocity, pitch=p,
                                    start=marker.time, end=end))
    return midi
