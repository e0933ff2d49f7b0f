"""The port's HookTheory and Pop1K7 tokenizers (``data/hooktheory.py``,
``data/pop1k7.py``) and its data splits (``data/splits.py``) against the
JAX package on the same seeded inputs, exactly: the same MIDI, positions,
events and splits, compared with each value's Python type
(``test_torch_tokenizer.typed``).  The annotations and Pop1K7 songs are
``chip_smoke.py``'s synthetic ones.

The HookTheory split is sklearn's ``train_test_split`` in JAX, which this
sandbox has: ``ceil(0.1 * n)`` files to validation, taken first from a
``RandomState(42)`` permutation.  The port writes that in numpy and never
imports sklearn; n = 14 and 25 are where JAX's own fallback, which rounds,
would differ."""

import copy
import gzip
import json
import math

import numpy as np
import pytest

import chip_smoke
from emo_disentanger_tpu.data import hooktheory as jax_ht
from emo_disentanger_tpu.data import pop1k7 as jax_pop
from emo_disentanger_tpu.data import splits as jax_splits
from emo_disentanger_tpu_torch.data import hooktheory, pop1k7, splits
from test_torch_tokenizer import typed

KINDS = ['usable', 'usable', 'usable', 'usable', 'short', 'mode', 'meter']
CLIP_FLAGS = {
    'remi': dict(relative_chord=False, transpose_to_C=False),
    'functional': dict(relative_chord=True, transpose_to_C=False),
    'transpose': dict(relative_chord=False, transpose_to_C=True),
    'transpose-relative': dict(relative_chord=True, transpose_to_C=True),
}


def _clip(i):
    return chip_smoke.hooktheory_clip(np.random.RandomState(40 + i), KINDS[i])


# ---------------------------------------------------------------- HookTheory

def test_hooktheory_constants_match_jax():
    for name in ('SEVENTH', 'TRIAD', 'INTERVAL2SYMBOL', 'MELODY_OCTAVE', 'VELOCITY',
                 'MAJOR_INTERVALS', 'MINOR_INTERVALS'):
        assert getattr(hooktheory, name) == getattr(jax_ht, name), name


@pytest.mark.parametrize('invert', [True, False])
def test_chord_mhot_and_simplify_match_jax(invert):
    """Every stack of one to four intervals from 1 to 6, and 200 random
    stacks of five: the same multi-hot and the same simplification (or
    False)."""
    import itertools
    stacks = [list(s) for n in range(1, 5)
              for s in itertools.product(range(1, 7), repeat=n)]
    rng = np.random.RandomState(1)
    stacks += [[int(x) for x in rng.randint(1, 7, 5)] for _ in range(200)]
    for s in stacks:
        np.testing.assert_array_equal(hooktheory.chord_mhot(s), jax_ht.chord_mhot(s))
        got, want = hooktheory.chord_simplify(s, invert), jax_ht.chord_simplify(s, invert)
        assert typed(got) == typed(want), s


def test_clip_is_usable_matches_jax():
    clips = [_clip(i) for i in range(len(KINDS))]
    base = _clip(0)
    for edit in (lambda c: c.pop('tags'), lambda c: c['tags'].remove('HARMONY'),
                 lambda c: c['tags'].append('KEY_CHANGES'),
                 lambda c: c['annotations'].update(meters=[]),
                 lambda c: c['annotations']['meters'][0].update(beat_unit=8),
                 lambda c: c['annotations']['meters'][0].update(beats_per_bar=3),
                 lambda c: c['annotations'].update(keys=[]),
                 lambda c: c.pop('annotations')):
        clip = copy.deepcopy(base)
        edit(clip)
        clips.append(clip)
    got = [hooktheory.clip_is_usable(c) for c in clips]
    assert got == [jax_ht.clip_is_usable(c) for c in clips]
    assert got[:len(KINDS)] == [k != 'meter' and k != 'mode' for k in KINDS]


@pytest.mark.parametrize('flags', sorted(CLIP_FLAGS))
@pytest.mark.parametrize('i', range(5))
def test_annotation_to_midi_matches_jax(i, flags):
    ann = _clip(i)['annotations']
    got = hooktheory.annotation_to_midi(copy.deepcopy(ann), **CLIP_FLAGS[flags])
    want = jax_ht.annotation_to_midi(copy.deepcopy(ann), **CLIP_FLAGS[flags])
    assert typed(got) == typed(want)
    assert got.instruments[0].notes


@pytest.mark.parametrize('min_bars', [4, 0])
@pytest.mark.parametrize('rep', ['remi', 'functional', 'transpose'])
@pytest.mark.parametrize('i', range(5))
def test_clip_to_leadsheet_events_matches_jax(i, rep, min_bars):
    """Lead-sheet events in each representation; the three-bar clip gives
    None at ``min_bars=4`` and its events at 0."""
    kw = {'remi': dict(relative_chord=False, relative_melody=False),
          'functional': dict(relative_chord=True, relative_melody=True),
          'transpose': dict(relative_chord=False, relative_melody=False,
                            transpose_to_C=True)}[rep]
    clip = _clip(i)
    got = hooktheory.clip_to_leadsheet_events(copy.deepcopy(clip), min_bars=min_bars, **kw)
    want = jax_ht.clip_to_leadsheet_events(copy.deepcopy(clip), min_bars=min_bars, **kw)
    assert typed(got) == typed(want)
    assert (got is None) == (KINDS[i] == 'short' and min_bars == 4)


def test_load_and_find_key_hooktheory_match_jax(tmp_path):
    path = str(tmp_path / 'Hooktheory.json.gz')
    with gzip.open(path, 'wt') as f:
        json.dump({f'c{i}': _clip(i) for i in range(len(KINDS))}, f)
    got, want = hooktheory.load_hooktheory_json(path), jax_ht.load_hooktheory_json(path)
    assert typed(got) == typed(want)
    keys = hooktheory.find_key_hooktheory(got)
    assert typed(keys) == typed(jax_ht.find_key_hooktheory(want))
    assert 'c5' not in keys[0] and len(keys[0]) == len(KINDS) - 1   # dorian skipped


# ------------------------------------------------------------------- Pop1K7

POP_KEYS = ['C', 'e', 'G#', 'a#']


@pytest.mark.parametrize('key', POP_KEYS)
@pytest.mark.parametrize('relative', [False, True])
def test_pop1k7_chord_translation_matches_jax(relative, key):
    tmap = pop1k7._root2degree_map(key, relative)
    assert typed(tmap) == typed(jax_pop._root2degree_map(key, relative))
    for pc in range(12):
        for q in ('M', 'm7', 'o'):
            assert pop1k7._translate_chord(f'{pc}_{q}', key, tmap, relative) == \
                jax_pop._translate_chord(f'{pc}_{q}', key, tmap, relative)


@pytest.mark.parametrize('rep', ['remi', 'functional'])
@pytest.mark.parametrize('seed,key', list(enumerate(POP_KEYS)))
def test_pop1k7_emitters_match_jax(seed, key, rep):
    """``events_to_stage2`` (a chord on every quarter beat of each lead-sheet
    bar) and ``events_to_fullsong`` (Tempo and Chord on every quarter beat)
    in each representation."""
    flags = dict(relative_chord=rep == 'functional', relative_melody=rep == 'functional')
    sky, mid, events = chip_smoke.pop1k7_song(np.random.RandomState(60 + seed), 6)
    got = pop1k7.events_to_stage2(copy.deepcopy(events), key, **flags)
    assert typed(got) == typed(jax_pop.events_to_stage2(copy.deepcopy(events), key, **flags))
    got = pop1k7.events_to_fullsong(list(sky), list(mid), copy.deepcopy(events), key, **flags)
    assert typed(got) == typed(jax_pop.events_to_fullsong(
        list(sky), list(mid), copy.deepcopy(events), key, **flags))
    assert got[1][-1] == {'name': 'EOS', 'value': None} and len(got[0]) == len(mid)


def test_pop1k7_refuses_a_song_without_its_tempo():
    _, mid, events = chip_smoke.pop1k7_song(np.random.RandomState(3), 2)
    with pytest.raises(ValueError, match='Tempo'):
        pop1k7.events_to_fullsong([(0, 0)] * 2, mid, events[1:], 'C',
                                  relative_chord=False, relative_melody=False)


# ------------------------------------------------------------------- splits

def test_split_emopia_matches_jax(tmp_path):
    split = tmp_path / 'split'
    split.mkdir()
    for name, n in (('train', 7), ('val', 2), ('test', 3)):
        (split / f'{name}_clip.csv').write_text(
            'idx,clip_name,mode\n' + ''.join(f'{i},Q{1 + i % 4}_{name}{i}_0.mid,0\n'
                                             for i in range(n)))
    got = splits.split_emopia(str(split), str(tmp_path / 'port'))
    want = jax_splits.split_emopia(str(split), str(tmp_path / 'jax'))
    assert typed(got) == typed(want)
    for f in ('train.pkl', 'valid.pkl'):
        assert (tmp_path / 'port' / f).read_bytes() == (tmp_path / 'jax' / f).read_bytes()


@pytest.mark.parametrize('n', [10, 14, 25, 30, 103])
def test_split_hooktheory_matches_jax(n, tmp_path):
    """sklearn's semantics without sklearn: the same split and pickles as
    JAX's sklearn call, ``ceil(0.1 * n)`` files to validation (3 at n=25,
    where rounding gives 2; 4 at n=30, where 0.1 * 30 is a hair over 3)."""
    events = tmp_path / 'events'
    events.mkdir()
    rng = np.random.RandomState(n)
    for i in rng.permutation(n):
        (events / f'clip{i:03d}.pkl').write_bytes(b'')
    got = splits.split_hooktheory(str(events), str(tmp_path / 'port'))
    want = jax_splits.split_hooktheory(str(events), str(tmp_path / 'jax'))
    assert typed(got) == typed(want)
    assert len(got[1]) == math.ceil(0.1 * n)
    for f in ('train.pkl', 'valid.pkl'):
        assert (tmp_path / 'port' / f).read_bytes() == (tmp_path / 'jax' / f).read_bytes()


@pytest.mark.parametrize('n,test_size', [(1, 0.1), (5, 0.0), (5, 1.0)])
def test_shuffle_split_refuses_as_sklearn_does(n, test_size):
    from sklearn.model_selection import train_test_split
    items = [f'c{i}' for i in range(n)]
    with pytest.raises(ValueError):
        train_test_split(items, test_size=test_size, random_state=42)
    with pytest.raises(ValueError):
        splits.shuffle_split(items, test_size, 42)
