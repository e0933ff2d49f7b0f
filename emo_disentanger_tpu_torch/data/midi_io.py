"""Minimal Standard MIDI File (SMF) reader/writer (copy of
``emo_disentanger_tpu/data/midi_io.py``: the same ``MidiFile`` writes the
same bytes).

The reference delegates MIDI I/O to ``miditoolkit``; this framework owns the
format instead.  Only the features the pipelines need are implemented:

* format 0/1 files, tick-based timing;
* note on/off (with running status), program change;
* meta events: set-tempo, marker, track name, time signature, end-of-track.

Containers mirror the shapes the tokenizers expect (notes with
start/end/pitch/velocity, tempo changes, text markers, time signatures).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Note:
    velocity: int
    pitch: int
    start: int
    end: int

    def __repr__(self):
        return f'Note(pitch={self.pitch}, start={self.start}, end={self.end}, vel={self.velocity})'


@dataclass
class TempoChange:
    tempo: float        # BPM
    time: int           # ticks


@dataclass
class Marker:
    text: str
    time: int


@dataclass
class TimeSignature:
    numerator: int
    denominator: int
    time: int


@dataclass
class Instrument:
    program: int = 0
    is_drum: bool = False
    name: str = ''
    notes: List[Note] = field(default_factory=list)


@dataclass
class MidiFile:
    ticks_per_beat: int = 480
    instruments: List[Instrument] = field(default_factory=list)
    tempo_changes: List[TempoChange] = field(default_factory=list)
    markers: List[Marker] = field(default_factory=list)
    time_signature_changes: List[TimeSignature] = field(default_factory=list)
    max_tick: int = 0

    # ------------------------------------------------------------------ io
    @classmethod
    def parse(cls, path: str) -> 'MidiFile':
        with open(path, 'rb') as f:
            data = f.read()
        return cls.parse_bytes(data)

    @classmethod
    def parse_bytes(cls, data: bytes) -> 'MidiFile':
        if data[:4] != b'MThd':
            raise ValueError('not a MIDI file (missing MThd)')
        hdr_len, fmt, ntrks, division = struct.unpack('>IHHH', data[4:14])
        if division & 0x8000:
            raise ValueError('SMPTE time division not supported')
        midi = cls(ticks_per_beat=division)

        pos = 8 + hdr_len
        for _ in range(ntrks):
            if pos + 8 > len(data):
                break
            if data[pos:pos + 4] != b'MTrk':
                raise ValueError('bad track chunk')
            (trk_len,) = struct.unpack('>I', data[pos + 4:pos + 8])
            track = data[pos + 8:pos + 8 + trk_len]
            pos += 8 + trk_len
            midi._parse_track(track)

        for inst in midi.instruments:
            inst.notes.sort(key=lambda n: (n.start, n.pitch))
            if inst.notes:
                midi.max_tick = max(midi.max_tick, max(n.end for n in inst.notes))
        midi.tempo_changes.sort(key=lambda t: t.time)
        midi.markers.sort(key=lambda m: m.time)
        return midi

    def _parse_track(self, track: bytes) -> None:
        i = 0
        tick = 0
        running_status = 0
        track_name = ''
        program = 0
        # pitch -> list of (start_tick, velocity), FIFO per pitch*channel
        open_notes = {}
        notes: List[Note] = []

        def read_varlen() -> int:
            nonlocal i
            value = 0
            while True:
                b = track[i]
                i += 1
                value = (value << 7) | (b & 0x7F)
                if not b & 0x80:
                    return value

        while i < len(track):
            tick += read_varlen()
            status = track[i]
            if status & 0x80:
                i += 1
                if status < 0xF0:
                    running_status = status
            else:
                status = running_status

            etype = status & 0xF0
            channel = status & 0x0F
            if etype == 0x90:  # note on
                pitch, vel = track[i], track[i + 1]
                i += 2
                keyid = (channel, pitch)
                if vel > 0:
                    open_notes.setdefault(keyid, []).append((tick, vel))
                else:  # velocity-0 note-on == note-off
                    if open_notes.get(keyid):
                        st, v = open_notes[keyid].pop(0)
                        notes.append(Note(velocity=v, pitch=pitch, start=st, end=tick))
            elif etype == 0x80:  # note off
                pitch = track[i]
                i += 2
                keyid = (channel, pitch)
                if open_notes.get(keyid):
                    st, v = open_notes[keyid].pop(0)
                    notes.append(Note(velocity=v, pitch=pitch, start=st, end=tick))
            elif etype in (0xA0, 0xB0, 0xE0):  # aftertouch / CC / pitch bend
                i += 2
            elif etype == 0xC0:  # program change
                program = track[i]
                i += 1
            elif etype == 0xD0:  # channel pressure
                i += 1
            elif status == 0xFF:  # meta
                meta_type = track[i]
                i += 1
                length = read_varlen()
                payload = track[i:i + length]
                i += length
                if meta_type == 0x51:  # set tempo (us / quarter)
                    us = int.from_bytes(payload, 'big')
                    self.tempo_changes.append(TempoChange(tempo=60_000_000 / us, time=tick))
                elif meta_type == 0x06:  # marker
                    self.markers.append(Marker(text=payload.decode('latin-1'), time=tick))
                elif meta_type == 0x03:  # track name
                    track_name = payload.decode('latin-1')
                elif meta_type == 0x58 and length >= 2:  # time signature
                    self.time_signature_changes.append(
                        TimeSignature(numerator=payload[0], denominator=1 << payload[1], time=tick))
                elif meta_type == 0x2F:  # end of track
                    break
            elif status in (0xF0, 0xF7):  # sysex
                length = read_varlen()
                i += length
            else:
                raise ValueError(f'unhandled MIDI status byte 0x{status:02x}')

        # close any dangling notes at track end
        for (channel, pitch), stack in open_notes.items():
            for st, v in stack:
                if tick > st:
                    notes.append(Note(velocity=v, pitch=pitch, start=st, end=tick))

        if notes:
            notes.sort(key=lambda n: (n.start, n.pitch))
            self.instruments.append(
                Instrument(program=program, is_drum=False, name=track_name, notes=notes))
        self.max_tick = max(self.max_tick, tick)

    def to_resolution(self, target: int = 480) -> 'MidiFile':
        """Return a copy rescaled to ``target`` ticks per beat.

        The tokenizers (like the reference's ``analyzer``, which overwrites
        ``ticks_per_beat`` with ``BEAT_RESOL`` without rescaling,
        ``midi2events_emopia.py:87`` — EMOPIA files are all 480 PPQN) assume
        480-PPQN ticks; real-world files at other divisions go through this
        first."""
        import copy as _copy
        if self.ticks_per_beat == target:
            return _copy.deepcopy(self)        # always a copy, per contract
        scale = target / float(self.ticks_per_beat)
        out = _copy.deepcopy(self)
        out.ticks_per_beat = target

        def r(t: int) -> int:
            # deterministic half-up rounding: Python round() ties-to-even
            # would shift .5-tick boundaries differently per parity on odd
            # PPQN inputs (advisor r3); floor(+0.5) keeps it monotone
            return math.floor(t * scale + 0.5)

        for inst in out.instruments:
            for n in inst.notes:
                n.start, n.end = r(n.start), max(r(n.start) + 1, r(n.end))
        for tc in out.tempo_changes:
            tc.time = r(tc.time)
        for m in out.markers:
            m.time = r(m.time)
        for ts in out.time_signature_changes:
            ts.time = r(ts.time)
        out.max_tick = r(out.max_tick)
        return out

    # ---------------------------------------------------------------- dump
    def dump(self, path: Optional[str] = None, *, filename: Optional[str] = None) -> None:
        """Write the SMF bytes; accepts ``filename=`` as a keyword alias
        (miditoolkit's dump signature, used by the reference pipelines)."""
        target = path if path is not None else filename
        if target is None:
            raise TypeError('dump() needs a path')
        with open(target, 'wb') as f:
            f.write(self.to_bytes())

    def to_bytes(self) -> bytes:
        def varlen(v: int) -> bytes:
            out = bytearray([v & 0x7F])
            v >>= 7
            while v:
                out.insert(0, 0x80 | (v & 0x7F))
                v >>= 7
            return bytes(out)

        def track_chunk(events: List[Tuple[int, bytes]]) -> bytes:
            events.sort(key=lambda e: e[0])
            body = bytearray()
            last = 0
            for t, payload in events:
                body += varlen(max(0, t - last)) + payload
                last = t
            body += varlen(0) + b'\xff\x2f\x00'
            return b'MTrk' + struct.pack('>I', len(body)) + bytes(body)

        chunks = []
        # conductor track: tempo / time sig / markers
        conductor: List[Tuple[int, bytes]] = []
        for ts in (self.time_signature_changes or [TimeSignature(4, 4, 0)]):
            denom_pow = max(0, ts.denominator.bit_length() - 1)
            conductor.append((ts.time, bytes([0xFF, 0x58, 0x04, ts.numerator, denom_pow, 24, 8])))
        for tc in (self.tempo_changes or [TempoChange(120.0, 0)]):
            us = int(round(60_000_000 / tc.tempo))
            conductor.append((tc.time, bytes([0xFF, 0x51, 0x03]) + us.to_bytes(3, 'big')))
        for m in self.markers:
            text = m.text.encode('latin-1', errors='replace')
            conductor.append((m.time, bytes([0xFF, 0x06]) + varlen(len(text)) + text))
        chunks.append(track_chunk(conductor))

        for ch, inst in enumerate(self.instruments):
            channel = min(ch, 15)
            if channel == 9:  # skip percussion channel for piano tracks
                channel = 10 if len(self.instruments) > 10 else 9
            evs: List[Tuple[int, bytes]] = []
            if inst.name:
                name = inst.name.encode('latin-1', errors='replace')
                evs.append((0, bytes([0xFF, 0x03]) + varlen(len(name)) + name))
            evs.append((0, bytes([0xC0 | channel, inst.program & 0x7F])))
            for n in inst.notes:
                evs.append((n.start, bytes([0x90 | channel, n.pitch & 0x7F, max(1, min(127, n.velocity))])))
                evs.append((n.end, bytes([0x80 | channel, n.pitch & 0x7F, 0x40])))
            chunks.append(track_chunk(evs))

        header = b'MThd' + struct.pack('>IHHH', 6, 1, len(chunks), self.ticks_per_beat)
        return header + b''.join(chunks)
