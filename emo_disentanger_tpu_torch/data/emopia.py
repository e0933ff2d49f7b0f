"""EMOPIA+ MIDI -> event-sequence tokenizer (port of
``emo_disentanger_tpu/data/emopia.py``).

Behavioral parity with the reference pipeline (``midi2events_emopia.py``):
``analyze_midi`` regularizes a performance MIDI (melody-overlap removal,
per-beat chord markers with repeat/Conti fill, chord-root -> scale-degree
translation, per-beat tempo fill, global bpm = median of the first 40 tempo
events), ``quantize_to_corpus`` snaps everything onto the 16th-note grid, and
the three ``corpus_to_*`` emitters produce the lead-sheet (stage 1),
interleaved lead+full (stage 2) and one-stage full-song event layouts.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.theory import (
    MAJOR_KEY, IDX_TO_KEY, KEY_TO_IDX,
    MAJOR_DEGREE_TO_ROMAN, MINOR_DEGREE_TO_ROMAN, pitch2degree,
)
from ..core.quantize import (
    BEAT_RESOL, BAR_RESOL, TICK_RESOL,
    DEFAULT_TEMPO, DEFAULT_VELOCITY_BINS, DEFAULT_BPM_BINS, DEFAULT_SHIFT_BINS,
    nearest_bin, quantize_notes, quantize_tick,
)
from ..core.events import Event
from .midi_io import MidiFile, Marker, TempoChange

# 30+ chord qualities simplified to the 11 standard ones
# (reference: ``midi2events_emopia.py:49-62``)
SIMPLIFY_QUALITY = {
    'maj': 'M', 'min': 'm', 'aug': '+', 'dim': 'o',
    'sus4': 'sus4', 'sus2': 'sus2', '7': '7', 'maj7': 'M7',
    'min7': 'm7', 'dim7': 'o7', 'hdim7': '/o7', 'None': 'None',
}

NONE_CHORD = 'None_None_None'
CONTI_CHORD = 'Conti_Conti_Conti'


@dataclass
class QuantNote:
    pitch: int
    velocity: int
    duration: int
    shift: int


@dataclass
class QuantChord:
    text: str           # "root_quality_bass" after degree translation


@dataclass
class QuantTempo:
    tempo: object       # int bpm or 'Conti'


@dataclass
class Corpus:
    """Grid-quantized song: tick -> items maps plus global metadata."""
    notes: Dict[int, List[QuantNote]] = field(default_factory=dict)
    chords: Dict[int, List[QuantChord]] = field(default_factory=dict)
    tempos: Dict[int, List[QuantTempo]] = field(default_factory=dict)
    global_bpm: int = DEFAULT_TEMPO
    global_key: str = 'C'
    last_bar: int = 0


def find_key_emopia(csv_path: str):
    """Per-clip key name/mode from the EMOPIA+ ``key_mode_tempo.csv``
    (reference ``find_key_emopia``, ``convert_key.py:79-90``; the pipeline
    CLI uses ``adjust_keyname.json`` instead, ``midi2events_emopia.py:735``).
    """
    import csv as _csv
    with open(csv_path, 'r') as f:
        rows = list(_csv.reader(f))
    clip2keyname: Dict[str, str] = {}
    clip2keymode: Dict[str, int] = {}
    for row in rows[1:]:
        name, keyname = row[1], row[2]
        clip2keyname[name] = keyname
        clip2keymode[name] = 0 if keyname in MAJOR_KEY else 1
    return clip2keyname, clip2keymode


# ---------------------------------------------------------------------------
# stage A: regularize the raw MIDI
# ---------------------------------------------------------------------------

def analyze_midi(midi: MidiFile, keyname: str, *,
                 melody_only: bool = True,
                 chord_conti: bool = False,
                 tempo_conti: bool = False,
                 relative_chord: bool = False,
                 transpose_to_C: bool = False) -> MidiFile:
    """Regularize a raw EMOPIA MIDI (reference ``analyzer``,
    ``midi2events_emopia.py:65-189``)."""
    if melody_only:
        notes = [copy.copy(n) for n in midi.instruments[0].notes]
        max_tick = max(n.end for n in notes)
    else:
        notes = [copy.copy(n)
                 for inst in midi.instruments[:3] for n in inst.notes]
        max_tick = midi.max_tick
    notes.sort(key=lambda n: (n.start, n.pitch))

    out = MidiFile(ticks_per_beat=BEAT_RESOL)
    out.tempo_changes = []  # rebuilt below

    # melody overlap removal: clip each note at the next onset
    if melody_only:
        for a, b in zip(notes[:-1], notes[1:]):
            a.end = min(b.start, a.end)

    # optional transposition to C major / c minor
    if transpose_to_C:
        tonic = KEY_TO_IDX[keyname.upper()]
        pitch_offset = (12 - tonic) if tonic >= 6 else -tonic
        for n in notes:
            n.pitch = min(108, max(21, n.pitch + pitch_offset))
    else:
        pitch_offset = 0

    out.instruments.append(
        type(midi.instruments[0])(program=0, is_drum=False, name='piano', notes=notes))

    # --- chords: quantize markers to beats, fill gaps with repeat or Conti ---
    beat2chord: Dict[int, str] = {}
    for m in midi.markers:
        if m.text.startswith('global') or 'Boundary' in m.text:
            continue
        qt = int(np.round(m.time / BEAT_RESOL) * BEAT_RESOL)
        root, quality, bass = m.text.split('_')
        beat2chord[qt] = '_'.join([root, SIMPLIFY_QUALITY[quality], bass])

    filled: List[Marker] = []
    prev = NONE_CHORD
    max_beat = int(np.ceil(max_tick / BEAT_RESOL) * BEAT_RESOL)
    for beat in range(0, max_beat, BEAT_RESOL):
        if beat in beat2chord:
            prev = beat2chord[beat]
            filled.append(Marker(text=prev, time=beat))
        else:
            filled.append(Marker(text=CONTI_CHORD if chord_conti else prev, time=beat))

    # chord roots -> scale-degree strings ('0'..'11'), relative to key if asked
    root2degree = {MAJOR_KEY[i]: str(i) for i in range(12)}
    if relative_chord:
        start = int(np.where(MAJOR_KEY == keyname.upper())[0][0])
        rotated = np.concatenate([MAJOR_KEY[start:], MAJOR_KEY[:start]])
        root2degree = {rotated[i]: str(i) for i in range(12)}

    markers: List[Marker] = []
    for m in filled:
        if 'None' in m.text or 'Conti' in m.text:
            markers.append(m)
            continue
        root, quality, bass = m.text.split('_')
        if transpose_to_C:
            root = IDX_TO_KEY[(KEY_TO_IDX[root] + pitch_offset) % 12]
            bass = IDX_TO_KEY[(KEY_TO_IDX[bass] + pitch_offset) % 12]
        markers.append(Marker(
            text='_'.join([root2degree[root], quality, root2degree[bass]]),
            time=m.time))
    out.markers = markers

    # --- global bpm: median of the first 40 tempo events ---
    tempos = [t.tempo for t in midi.tempo_changes][:40] or [float(DEFAULT_TEMPO)]
    global_bpm = int(np.median(tempos))
    out.markers.insert(0, Marker(text='global_bpm_' + str(global_bpm), time=0))

    # --- per-beat tempo fill ---
    tick2tempo = {t.time: t for t in midi.tempo_changes}
    prev_tempo = TempoChange(tempo=float(global_bpm), time=0)
    tempo_changes: List[TempoChange] = []
    for tick in range(0, (midi.max_tick // BEAT_RESOL + 1) * BEAT_RESOL, BEAT_RESOL):
        if tick in tick2tempo:
            prev_tempo = tick2tempo[tick]
            tempo_changes.append(TempoChange(tempo=prev_tempo.tempo, time=tick))
        elif tempo_conti:
            tempo_changes.append(TempoChange(tempo='Conti', time=tick))
        else:
            tempo_changes.append(TempoChange(tempo=prev_tempo.tempo, time=tick))
    out.tempo_changes = tempo_changes

    # --- global key ---
    if transpose_to_C:
        keyname = 'C' if keyname in MAJOR_KEY else 'c'
    out.markers.insert(0, Marker(text='global_key_' + keyname, time=0))
    out.max_tick = max_tick
    return out


# ---------------------------------------------------------------------------
# stage B: grid quantization
# ---------------------------------------------------------------------------

def quantize_to_corpus(midi: MidiFile) -> Corpus:
    """Snap a regularized MIDI onto the 16th-note grid (reference
    ``midi2corpus``, ``midi2events_emopia.py:192-364``)."""
    corpus = Corpus()

    notes = sorted(midi.instruments[0].notes, key=lambda n: (n.start, -n.pitch))

    for m in midi.markers:
        head = m.text.split('_')[0]
        if head == 'global':
            parts = m.text.split('_')
            if parts[1] == 'bpm':
                corpus.global_bpm = int(parts[2])
            elif parts[1] == 'key':
                corpus.global_key = parts[2]

    # empty-bar offset from the first quantized note
    first_note_time = notes[0].start
    last_note_time = notes[-1].start
    offset_bars = quantize_tick(first_note_time) // BAR_RESOL
    corpus.last_bar = int(np.ceil(last_note_time / BAR_RESOL)) - offset_bars
    shift_ticks = offset_bars * BAR_RESOL

    # notes: velocity/shift binning, duration rounding (cap 1 bar, drop 0)
    starts = np.asarray([n.start for n in notes], dtype=np.int64)
    ends = np.asarray([n.end for n in notes], dtype=np.int64)
    vels = np.asarray([n.velocity for n in notes], dtype=np.int64)
    qts, durs, vbins, shifts = quantize_notes(
        starts, ends, vels, shift_ticks, TICK_RESOL, BAR_RESOL,
        DEFAULT_VELOCITY_BINS, DEFAULT_SHIFT_BINS)
    for i, n in enumerate(notes):
        if durs[i] < 0:          # duration rounded to zero: dropped
            continue
        corpus.notes.setdefault(int(qts[i]), []).append(
            QuantNote(pitch=n.pitch, velocity=int(vbins[i]),
                      duration=int(durs[i]), shift=int(shifts[i])))

    # chords: quantize, keep the last non-Conti marker per grid cell
    chord_grid: Dict[int, List[Marker]] = {}
    for m in midi.markers:
        if m.text.split('_')[0] == 'global' or 'Boundary' in m.text:
            continue
        t = max(0, m.time - shift_ticks)
        chord_grid.setdefault(quantize_tick(t), []).append(m)
    for qt, items in chord_grid.items():
        chosen = items[0]
        if len(items) > 1:
            for c in reversed(items):
                if c.text != CONTI_CHORD:
                    chosen = c
                    break
        corpus.chords[qt] = [QuantChord(text=chosen.text)]

    # tempos: snap value to bpm bins (Conti passes through), last-non-Conti dedup
    tempo_grid: Dict[int, List[QuantTempo]] = {}
    for t in midi.tempo_changes:
        tt = max(0, t.time - shift_ticks)
        val = t.tempo if t.tempo == 'Conti' else nearest_bin(DEFAULT_BPM_BINS, t.tempo)
        tempo_grid.setdefault(quantize_tick(tt), []).append(QuantTempo(tempo=val))
    for qt, items in tempo_grid.items():
        chosen = items[0]
        if len(items) > 1:
            for t in reversed(items):
                if t.tempo != 'Conti':
                    chosen = t
                    break
        corpus.tempos[qt] = [chosen]

    corpus.global_bpm = nearest_bin(DEFAULT_BPM_BINS, corpus.global_bpm)
    return corpus


# ---------------------------------------------------------------------------
# stage C: event layout emitters
# ---------------------------------------------------------------------------

def _chord_event(text: str, key: str, relative_melody: bool) -> dict:
    """'root_quality_bass' -> Chord event, Roman root if functional."""
    root, quality, _bass = text.split('_')
    if relative_melody and root not in ('None', 'Conti'):
        table = MAJOR_DEGREE_TO_ROMAN if key in MAJOR_KEY else MINOR_DEGREE_TO_ROMAN
        root = table[int(root)]
    return Event('Chord', root + '_' + quality)


def _note_events(note: QuantNote, key: str, relative_melody: bool,
                 with_velocity: bool) -> List[dict]:
    evs: List[dict] = []
    if relative_melody:
        octave, roman = pitch2degree(key, note.pitch)
        evs.append(Event('Note_Octave', octave))
        evs.append(Event('Note_Degree', roman))
    else:
        evs.append(Event('Note_Pitch', note.pitch))
    evs.append(Event('Note_Duration', note.duration))
    if with_velocity:
        evs.append(Event('Note_Velocity', note.velocity))
    return evs


def corpus_to_leadsheet(corpus: Corpus, emotion: Optional[str], *,
                        relative_melody: bool = False,
                        relative_chord: bool = False) -> Tuple[List[int], List[dict]]:
    """Stage-1 lead-sheet layout (reference ``corpus2lead``,
    ``midi2events_emopia.py:374-461``):
    Emotion [Key] { Bar { Beat Chord? Note* }* }* EOS
    """
    key = corpus.global_key
    seq: List[dict] = [Event('Emotion', emotion)]
    if relative_chord:
        seq.append(Event('Key', key))

    positions: List[int] = []
    global_end = corpus.last_bar * BAR_RESOL
    for bar_step in range(0, global_end, BAR_RESOL):
        bar_seq = [Event('Bar', None)]
        for timing in range(bar_step, bar_step + BAR_RESOL, TICK_RESOL):
            evs: List[dict] = []
            for ch in corpus.chords.get(timing, []):
                evs.append(_chord_event(ch.text, key, relative_melody))
            for note in corpus.notes.get(timing, []):
                evs.extend(_note_events(note, key, relative_melody, with_velocity=False))
            if evs:
                bar_seq.append(Event('Beat', (timing - bar_step) // TICK_RESOL))
                bar_seq.extend(evs)
        if bar_step == global_end - BAR_RESOL:
            bar_seq.append(Event('EOS', None))
        positions.append(len(seq))
        seq.extend(bar_seq)

    return positions, seq


def corpus_to_stage2(lead: Corpus, full: Corpus, emotion: Optional[str], *,
                     relative_melody: bool = False,
                     relative_chord: bool = False,
                     ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]], List[dict]]:
    """Stage-2 per-bar interleaved layout (reference ``corpus2full``,
    ``midi2events_emopia.py:464-594``):
    Emotion [Key] Tempo { Track_LeadSheet Bar <lead events> [EOS]
                          Track_Full Bar <full events incl. tempo+velocity> }*
    """
    key = lead.global_key
    seq: List[dict] = [Event('Emotion', emotion)]
    if relative_chord:
        seq.append(Event('Key', key))
    seq.append(Event('Tempo', lead.global_bpm))

    lead_pos: List[Tuple[int, int]] = []
    full_pos: List[Tuple[int, int]] = []
    global_end = lead.last_bar * BAR_RESOL

    for bar_step in range(0, global_end, BAR_RESOL):
        lead_seq = [Event('Track', 'LeadSheet'), Event('Bar', None)]
        full_seq = [Event('Track', 'Full'), Event('Bar', None)]

        for timing in range(bar_step, bar_step + BAR_RESOL, TICK_RESOL):
            beat_val = (timing - bar_step) // TICK_RESOL

            lead_evs: List[dict] = []
            for ch in lead.chords.get(timing, []):
                lead_evs.append(_chord_event(ch.text, key, relative_melody))
            for note in lead.notes.get(timing, []):
                lead_evs.extend(_note_events(note, key, relative_melody, with_velocity=False))
            if lead_evs:
                lead_seq.append(Event('Beat', beat_val))
                lead_seq.extend(lead_evs)

            full_evs: List[dict] = []
            for t in full.tempos.get(timing, []):
                full_evs.append(Event('Tempo', t.tempo))
            for ch in full.chords.get(timing, []):
                full_evs.append(_chord_event(ch.text, key, relative_melody))
            for note in full.notes.get(timing, []):
                full_evs.extend(_note_events(note, key, relative_melody, with_velocity=True))
            if full_evs:
                full_seq.append(Event('Beat', beat_val))
                full_seq.extend(full_evs)

        if bar_step == global_end - BAR_RESOL:
            lead_seq.append(Event('EOS', None))

        lead_start = len(seq)
        seq.extend(lead_seq)
        lead_pos.append((lead_start, len(seq)))
        full_start = len(seq)
        seq.extend(full_seq)
        full_pos.append((full_start, len(seq)))

    return lead_pos, full_pos, seq


def corpus_to_fullsong(corpus: Corpus, emotion: Optional[str], *,
                       relative_melody: bool = False,
                       relative_chord: bool = False) -> Tuple[List[int], List[dict]]:
    """One-stage full-song layout (reference ``corpus2lead_full``,
    ``midi2events_emopia.py:597-685``): like the lead sheet but with
    per-beat tempo events and note velocities, 4-quadrant emotions."""
    key = corpus.global_key
    seq: List[dict] = [Event('Emotion', emotion)]
    if relative_chord:
        seq.append(Event('Key', key))
    seq.append(Event('Tempo', corpus.global_bpm))

    positions: List[int] = []
    global_end = corpus.last_bar * BAR_RESOL
    for bar_step in range(0, global_end, BAR_RESOL):
        bar_seq = [Event('Bar', None)]
        for timing in range(bar_step, bar_step + BAR_RESOL, TICK_RESOL):
            evs: List[dict] = []
            for t in corpus.tempos.get(timing, []):
                evs.append(Event('Tempo', t.tempo))
            for ch in corpus.chords.get(timing, []):
                evs.append(_chord_event(ch.text, key, relative_melody))
            for note in corpus.notes.get(timing, []):
                evs.extend(_note_events(note, key, relative_melody, with_velocity=True))
            if evs:
                bar_seq.append(Event('Beat', (timing - bar_step) // TICK_RESOL))
                bar_seq.extend(evs)
        if bar_step == global_end - BAR_RESOL:
            bar_seq.append(Event('EOS', None))
        positions.append(len(seq))
        seq.extend(bar_seq)

    return positions, seq
