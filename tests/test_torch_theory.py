"""The port's music-theory, event and quantization cores (copies, not
imports) against the JAX package's: every function and table gives the
same result, exhaustively over keys, octaves and degrees, and on seeded
event lists."""

import numpy as np
import pytest

from emo_disentanger_tpu.core import events as jevents
from emo_disentanger_tpu.core import quantize as jquant
from emo_disentanger_tpu.core import theory as jtheory
from emo_disentanger_tpu_torch import core as tcore
from emo_disentanger_tpu_torch.core import events as tevents
from emo_disentanger_tpu_torch.core import quantize as tquant
from emo_disentanger_tpu_torch.core import theory as ttheory
from emo_disentanger_tpu_torch.core import vocab as tvocab

ALL_KEYS = list(jtheory.MAJOR_KEY) + list(jtheory.MINOR_KEY)
MINOR_MAPS = [('III', 'VII', 3, 8), ('IV', 'I', 2, 7)]


def test_tables_match_jax():
    for name in ('MAJOR_KEY', 'MINOR_KEY'):
        assert getattr(ttheory, name).tolist() == getattr(jtheory, name).tolist()
    for name in ('IDX_TO_KEY', 'KEY_TO_IDX', 'MAJOR_DEGREE_TO_ROMAN',
                 'ROMAN_TO_MAJOR_DEGREE', 'MINOR_DEGREE_TO_ROMAN',
                 'ROMAN_TO_MINOR_DEGREE'):
        assert getattr(ttheory, name) == getattr(jtheory, name), name
    for args in MINOR_MAPS:
        assert ttheory.make_minor_maps(*args) == jtheory.make_minor_maps(*args)
    # the vocabulary takes its constants from the port's theory module
    assert tvocab.MAJOR_KEY is ttheory.MAJOR_KEY
    assert tvocab.KEY_TO_IDX is ttheory.KEY_TO_IDX
    assert tvocab.VOCAB_DURATION_VALUES is tquant.VOCAB_DURATION_VALUES


@pytest.mark.parametrize('key', ALL_KEYS)
def test_degree_pitch_match_jax(key):
    """degree2pitch over every octave and Roman degree the key's table
    knows, pitch2degree over every MIDI pitch, with the default and an
    explicit minor resolution."""
    minor = key in jtheory.MINOR_KEY
    for d2r_args in MINOR_MAPS:
        d2r, r2d = jtheory.make_minor_maps(*d2r_args)
        romans = (r2d if minor else jtheory.ROMAN_TO_MAJOR_DEGREE).keys()
        for octave in range(11):
            for roman in romans:
                for kw in ({}, {'minor_map': r2d}):
                    assert ttheory.degree2pitch(key, octave, roman, **kw) == \
                        jtheory.degree2pitch(key, octave, roman, **kw)
        for pitch in range(128):
            for kw in ({}, {'minor_map': d2r}):
                assert ttheory.pitch2degree(key, pitch, **kw) == \
                    jtheory.pitch2degree(key, pitch, **kw)
    assert tcore.degree2pitch is ttheory.degree2pitch


def _seeded_events(seed):
    rng = np.random.RandomState(seed)
    key = ALL_KEYS[rng.randint(len(ALL_KEYS))]
    evs = [{'name': 'Key', 'value': key}]
    for _ in range(40):
        kind = rng.randint(4)
        if kind == 0:
            evs.append({'name': 'Note_Pitch', 'value': int(rng.randint(21, 109))})
        elif kind == 1:
            evs.append({'name': 'Note_Duration', 'value': int(rng.choice([120, 480]))})
        elif kind == 2:
            evs.append({'name': 'Beat', 'value': int(rng.randint(16))})
        else:
            evs.append({'name': 'Bar', 'value': None})
    return evs


@pytest.mark.parametrize('seed', range(6))
def test_absolute_relative_round_trip_matches_jax(seed):
    evs = _seeded_events(seed)
    rel = ttheory.absolute2relative(evs)
    assert rel == jtheory.absolute2relative(evs)
    assert ttheory.relative2absolute(rel) == jtheory.relative2absolute(rel)
    forced = {'name': 'Key', 'value': ALL_KEYS[seed * 3 % 24]}
    for fn in ('absolute2relative', 'relative2absolute'):
        src = evs if fn == 'absolute2relative' else rel
        assert getattr(ttheory, fn)(src, True, forced) == \
            getattr(jtheory, fn)(src, True, forced)
    # out-of-range octaves clamp to the piano range alike
    low = [{'name': 'Key', 'value': 'C'}, {'name': 'Note_Octave', 'value': 0},
           {'name': 'Note_Degree', 'value': 'I'}, {'name': 'Note_Octave', 'value': 10},
           {'name': 'Note_Degree', 'value': 'VII'}]
    assert ttheory.relative2absolute(low) == jtheory.relative2absolute(low)


def test_theory_errors_match_jax():
    for mod in (ttheory, jtheory):
        with pytest.raises(NameError):
            mod.pitch2degree('H', 60)
        with pytest.raises(ValueError):
            mod.absolute2relative([{'name': 'Bar', 'value': None}])
        with pytest.raises(ValueError):
            mod.relative2absolute([{'name': 'Key', 'value': 'C'},
                                   {'name': 'Note_Degree', 'value': 'I'}])


def test_switch_key_and_melody_match_jax():
    names = ALL_KEYS + ['Key_' + k for k in ALL_KEYS] + ['H', 'Key_H', 'Key_None']
    for name in names:
        assert ttheory.switch_key(name) == jtheory.switch_key(name)
    rng = np.random.RandomState(7)
    evs = [{'name': 'Note_Pitch', 'value': int(p)} for p in rng.randint(21, 109, 30)]
    evs.insert(5, {'name': 'Bar', 'value': None})
    for quadrant in ('Q1', 'Q2', 'Q3', 'Q4'):
        for mode in (0, 1):
            table = {f'{quadrant}_clip': mode}
            assert ttheory.switch_melody(f'{quadrant}_clip', evs, table) == \
                jtheory.switch_melody(f'{quadrant}_clip', evs, table)


def test_events_match_jax():
    samples = ['Note_Pitch_60', 'Note_Octave_5', 'Note_Degree_I#', 'Chord_I_M7',
               'Chord_None_None', 'Chord_0_/o7', 'Beat_12', 'Bar_None',
               'Tempo_110', 'Emotion_Positive', 'Key_c#', 'Track_LeadSheet']
    for ev in samples:
        assert tevents.split_event_str(ev) == jevents.split_event_str(ev)
    dicts = [tevents.Event('Beat', 3), jevents.Event('Note_Pitch', 60)]
    assert tevents.events_to_strs(dicts + samples) == \
        jevents.events_to_strs(dicts + samples)
    assert tevents.Event('Bar', None) == jevents.Event('Bar', None)
    assert tcore.event_str is tevents.event_str


def test_quantize_matches_jax():
    for name in ('BEAT_RESOL', 'BAR_RESOL', 'TICK_RESOL', 'POSITIONS_PER_BAR',
                 'DEFAULT_TEMPO', 'MIN_VELOCITY'):
        assert getattr(tquant, name) == getattr(jquant, name), name
    for name in ('DEFAULT_VELOCITY_BINS', 'DEFAULT_BPM_BINS', 'DEFAULT_SHIFT_BINS',
                 'DEFAULT_DURATION_BINS', 'VOCAB_DURATION_VALUES'):
        np.testing.assert_array_equal(getattr(tquant, name), getattr(jquant, name))
        assert getattr(tquant, name).dtype == getattr(jquant, name).dtype
    rng = np.random.RandomState(0)
    values = np.concatenate([rng.uniform(-100, 4000, 200), np.arange(0, 600, 30.0)])
    for bins in ('DEFAULT_VELOCITY_BINS', 'DEFAULT_BPM_BINS', 'DEFAULT_SHIFT_BINS'):
        for v in values:
            assert tquant.nearest_bin(getattr(tquant, bins), v) == \
                jquant.nearest_bin(getattr(jquant, bins), v)
    for v in values:
        assert tquant.quantize_tick(v) == jquant.quantize_tick(v)
        assert tquant.quantize_tick(v, 60) == jquant.quantize_tick(v, 60)
