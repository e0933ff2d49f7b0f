"""The port's Standard MIDI File reader and writer (a copy, not an import)
against the JAX package's: the same ``MidiFile`` writes the same bytes,
either package parses the other's bytes into equal fields, ``to_resolution``
agrees, and the cases of ``tests/test_midi_io.py`` and
``tests/test_midi_io_robustness.py`` pass with the port's classes in place
of the JAX package's."""

import dataclasses
import inspect

import numpy as np
import pytest

import test_midi_io
import test_midi_io_robustness
from emo_disentanger_tpu.data import midi_io as jmidi
from emo_disentanger_tpu_torch.data import midi_io as tmidi

CLASSES = ('MidiFile', 'Instrument', 'Note', 'TempoChange', 'Marker',
           'TimeSignature')


def _build(mod, seed):
    """A seeded MidiFile of ``mod``'s classes: several instruments (more
    than ten for seed 3, so the percussion-channel rule applies), tempo
    changes, markers (Latin-1 text), time signatures, overlapping notes."""
    rng = np.random.RandomState(seed)
    m = mod.MidiFile(ticks_per_beat=int(rng.choice([96, 384, 480, 960])))
    for _ in range(rng.randint(0, 3)):
        m.time_signature_changes.append(mod.TimeSignature(
            int(rng.choice([3, 4, 6])), int(rng.choice([2, 4, 8])),
            int(rng.randint(0, 8000))))
    for _ in range(rng.randint(0, 4)):
        m.tempo_changes.append(mod.TempoChange(
            float(rng.uniform(40, 220)), int(rng.randint(0, 8000))))
    for i in range(rng.randint(0, 5)):
        m.markers.append(mod.Marker(['Chord-C_M', 'Bar-1', 'caf\xe9 %d' % i][i % 3],
                                    int(rng.randint(0, 8000))))
    for k in range(12 if seed == 3 else rng.randint(1, 4)):
        inst = mod.Instrument(program=int(rng.randint(0, 128)),
                              name=['Piano', '', 'lead'][k % 3])
        for _ in range(rng.randint(0, 30)):
            start = int(rng.randint(0, 8000))
            inst.notes.append(mod.Note(velocity=int(rng.randint(0, 140)),
                                       pitch=int(rng.randint(0, 128)),
                                       start=start,
                                       end=start + int(rng.randint(1, 2000))))
        m.instruments.append(inst)
    m.max_tick = int(rng.randint(0, 10000))
    return m


def _fields(m):
    return dataclasses.asdict(m)


@pytest.mark.parametrize('seed', range(6))
def test_to_bytes_and_parse_match_jax(seed, tmp_path):
    jm, tm = _build(jmidi, seed), _build(tmidi, seed)
    assert _fields(tm) == _fields(jm)
    data = jm.to_bytes()
    assert tm.to_bytes() == data
    tm.dump(str(tmp_path / 't.mid'))
    jm.dump(filename=str(tmp_path / 'j.mid'))
    assert (tmp_path / 't.mid').read_bytes() == data == \
        (tmp_path / 'j.mid').read_bytes()
    # each parses the other's bytes into the same fields
    assert _fields(tmidi.MidiFile.parse_bytes(data)) == \
        _fields(jmidi.MidiFile.parse_bytes(data))
    assert _fields(tmidi.MidiFile.parse(str(tmp_path / 'j.mid'))) == \
        _fields(jmidi.MidiFile.parse(str(tmp_path / 't.mid')))
    for target in (96, 480, 960, 1000):
        got, want = tm.to_resolution(target), jm.to_resolution(target)
        assert _fields(got) == _fields(want)
        assert got is not tm and got.to_bytes() == want.to_bytes()


def test_errors_match_jax():
    for mod in (tmidi, jmidi):
        with pytest.raises(ValueError, match='MThd'):
            mod.MidiFile.parse_bytes(b'RIFF' + bytes(10))
        with pytest.raises(ValueError, match='track'):
            mod.MidiFile.parse_bytes(
                b'MThd' + bytes([0, 0, 0, 6, 0, 1, 0, 1, 1, 224]) + b'XXXX'
                + bytes(4))
        with pytest.raises(TypeError):
            mod.MidiFile().dump()


CASES = [(mod, name) for mod in (test_midi_io, test_midi_io_robustness)
         for name in sorted(vars(mod)) if name.startswith('test_')]


@pytest.mark.parametrize('mod,name', CASES,
                         ids=[f'{m.__name__}::{n}' for m, n in CASES])
def test_jax_midi_cases_on_the_port(mod, name, monkeypatch, tmp_path):
    """Each case of the JAX package's MIDI tests, with the port's classes
    in place of the JAX package's in that test module.  The robustness
    cases also feed the port's parsed files to the JAX tokenizer, whose
    only contract with them is these classes' fields."""
    for cls in CLASSES:
        if hasattr(mod, cls):
            monkeypatch.setattr(mod, cls, getattr(tmidi, cls))
    fn = getattr(mod, name)
    fn(**({'tmp_path': tmp_path} if 'tmp_path' in inspect.signature(fn).parameters
          else {}))
