"""The port's EMOPIA+ tokenizer (``core/quantize.py`` ``quantize_notes``,
``data/emopia.py``) and the ``midi2events`` / ``data-splits`` CLIs against
the JAX package on the same seeded inputs.

Everything here is exact: the same integers from ``quantize_notes`` as
JAX's g++-built ``csrc/emodis_native.cpp`` (the ties included), the same
regularized MIDI, ``Corpus``, bar positions and events, compared together
with each value's Python type (a ``np.int64`` where JAX has an ``int``
fails), and pickles written by both CLIs byte for byte.  The synthetic
songs, annotations and Pop1K7 pickles are ``chip_smoke.py``'s (its
``tokenized_training`` path tokenizes the same kinds of input on the card),
built once from each package's own ``midi_io`` classes."""

import dataclasses
import os
import pickle

import numpy as np
import pytest

import chip_smoke
from emo_disentanger_tpu import native
from emo_disentanger_tpu.cli import data_splits as jax_data_splits
from emo_disentanger_tpu.cli import midi2events as jax_midi2events
from emo_disentanger_tpu.core.quantize import (
    BAR_RESOL, DEFAULT_SHIFT_BINS, DEFAULT_VELOCITY_BINS, TICK_RESOL)
from emo_disentanger_tpu.core.vocab import Vocab as JaxVocab
from emo_disentanger_tpu.core.vocab import build_dictionary_from_dir
from emo_disentanger_tpu.data import emopia as jax_emopia
from emo_disentanger_tpu.data import midi_io as jax_midi_io
from emo_disentanger_tpu.data.datasets import Stage1Dataset as JaxStage1Dataset
from emo_disentanger_tpu.data.datasets import Stage2Dataset as JaxStage2Dataset
from emo_disentanger_tpu_torch.__main__ import main as port_main
from emo_disentanger_tpu_torch.core.events import events_to_strs
from emo_disentanger_tpu_torch.core.quantize import quantize_notes
from emo_disentanger_tpu_torch.data import emopia
from emo_disentanger_tpu_torch.data import midi_io

# the CPU tests' synthetic inputs: fewer and shorter than the card's
SMALL = dict(TOK_CLIPS=4, TOK_BARS=5, TOK_HT_CLIPS=10, TOK_POP_SONGS=3,
             TOK_POP_BARS=4)


def typed(x):
    """``x`` with dataclasses as dicts and every leaf beside its type's name:
    two values compare equal only where their Python types agree too."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return typed(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {typed(k): typed(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [typed(v) for v in x])
    return (type(x).__name__, x)


# ------------------------------------------------------------ quantize_notes

def _native(*args):
    assert native.AVAILABLE, 'the JAX package runs its C++ quantizer here'
    return native.quantize_notes(*args, TICK_RESOL, BAR_RESOL,
                                 DEFAULT_VELOCITY_BINS, DEFAULT_SHIFT_BINS)


def _same_quantized(starts, ends, vels, shift_ticks):
    got = quantize_notes(starts, ends, vels, shift_ticks, TICK_RESOL, BAR_RESOL,
                         DEFAULT_VELOCITY_BINS, DEFAULT_SHIFT_BINS)
    want = _native(starts, ends, vels, shift_ticks)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_quantize_notes_random_matches_native(seed):
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, 40 * BAR_RESOL, 2000)
    ends = starts + rng.randint(-100, 3 * BAR_RESOL, 2000)
    vels = rng.randint(0, 140, 2000)
    _same_quantized(starts, ends, vels, int(rng.randint(3)) * BAR_RESOL)


@pytest.mark.parametrize('shift_ticks', [0, BAR_RESOL])
def test_quantize_notes_ties_match_native(shift_ticks):
    """Starts and durations exactly half a grid step (60 ticks) off the
    grid round half to even; onset shifts exactly between two shift bins
    (odd ticks) and every velocity take the lower bin; negative, zero and
    capped durations."""
    k = np.arange(-4, 40)
    offsets = np.resize(np.arange(-60, 61, 3), len(k))
    starts = shift_ticks + np.concatenate([k * TICK_RESOL + 60,
                                           k * TICK_RESOL + offsets])
    starts = np.clip(starts, 0, None)
    durs = np.resize(np.concatenate([60 + TICK_RESOL * np.arange(-2, 17),
                                     [0, 1, 59, 61, BAR_RESOL - 60, BAR_RESOL + 60]]),
                     len(starts))
    vels = np.resize(np.arange(0, 131), len(starts))
    qt, dur, vel, shift = _same_quantized(starts, starts + durs, vels, shift_ticks)
    s = starts - shift_ticks
    assert ((s % TICK_RESOL == 60) & ((s // TICK_RESOL) % 2 == 0)).any()
    assert ((s % TICK_RESOL == 60) & ((s // TICK_RESOL) % 2 == 1)).any()
    assert (dur == -1).any() and (dur == BAR_RESOL).any()
    assert (((s - qt) % 2) == 1).any()
    all_vels = np.arange(0, 131)
    _same_quantized(np.zeros(131, np.int64), np.full(131, 480), all_vels, 0)


# -------------------------------------------------------------------- EMOPIA

SONGS = {
    # seed, key, empty bars before the first note, built directly or
    # written to MIDI bytes and parsed by each package
    'C-objects': (0, 'C', 0, False),
    'a-objects-lead-in': (1, 'a', 1, False),
    'F#-bytes': (2, 'F#', 0, True),
    'c#-bytes-lead-in': (3, 'c#', 1, True),
}
ANALYZE = {
    'melody': dict(melody_only=True),
    'melody-conti-relative': dict(melody_only=True, chord_conti=True,
                                  tempo_conti=True, relative_chord=True),
    'all-transpose': dict(melody_only=False, transpose_to_C=True),
    'all-conti-relative': dict(melody_only=False, chord_conti=True,
                               tempo_conti=True, relative_chord=True),
}


def _songs(name):
    """(JAX MidiFile, port MidiFile) of one synthetic song, and its key."""
    seed, key, lead_in, as_bytes = SONGS[name]
    if as_bytes:
        data = chip_smoke.emopia_clip(np.random.RandomState(seed), 6, midi_io,
                                      lead_in).to_bytes()
        return (jax_midi_io.MidiFile.parse_bytes(data),
                midi_io.MidiFile.parse_bytes(data), key)
    return tuple(chip_smoke.emopia_clip(np.random.RandomState(seed), 6, mio, lead_in)
                 for mio in (jax_midi_io, midi_io)) + (key,)


def test_synthetic_songs_hold_the_hazards():
    """The songs carry what the tests are for: zero-length and too-short
    melody notes, notes sharing an onset, notes past a bar, None chords,
    Boundary markers, several instruments and tempo changes."""
    _, song, _ = _songs('C-objects')
    mel = song.instruments[0].notes
    assert len(song.instruments) == 3 and len(song.tempo_changes) >= 3
    assert any(n.end == n.start for n in mel) and any(0 < n.end - n.start < 60 for n in mel)
    assert any(n.end - n.start > BAR_RESOL for n in mel)
    assert len({n.start for n in mel}) < len(mel)
    texts = [m.text for m in song.markers]
    assert 'None_None_None' in texts and 'Boundary' in texts


@pytest.mark.parametrize('flags', sorted(ANALYZE))
@pytest.mark.parametrize('song', sorted(SONGS))
def test_analyze_and_quantize_match_jax(song, flags):
    jsong, tsong, key = _songs(song)
    kw = ANALYZE[flags]
    jreg = jax_emopia.analyze_midi(jsong, key, **kw)
    treg = emopia.analyze_midi(tsong, key, **kw)
    assert typed(treg) == typed(jreg)
    assert typed(emopia.quantize_to_corpus(treg)) == \
        typed(jax_emopia.quantize_to_corpus(jreg))
    assert typed(tsong) == typed(jsong)          # the input is left as it was


def _corpora(pkg, song, key, flags, lead_kw=None):
    """(lead corpus, full corpus) as ``midi2events`` builds them."""
    lead = pkg.quantize_to_corpus(pkg.analyze_midi(song, key, melody_only=True,
                                                   **(lead_kw or {}), **flags))
    full = pkg.quantize_to_corpus(pkg.analyze_midi(song, key, melody_only=False,
                                                   chord_conti=True, tempo_conti=True,
                                                   **flags))
    return lead, full


REPRESENTATIONS = {
    'remi': (dict(), dict()),
    'functional': (dict(relative_chord=True), dict(relative_melody=True,
                                                   relative_chord=True)),
    'transpose': (dict(transpose_to_C=True), dict()),
}


@pytest.mark.parametrize('rep', sorted(REPRESENTATIONS))
@pytest.mark.parametrize('song', sorted(SONGS))
def test_emitters_match_jax(song, rep):
    """``corpus_to_leadsheet``, ``corpus_to_stage2`` and
    ``corpus_to_fullsong``: the same positions and events, typed, and the
    same event strings."""
    jsong, tsong, key = _songs(song)
    flags, emit = REPRESENTATIONS[rep]
    outs = {}
    for tag, pkg, s in (('jax', jax_emopia, jsong), ('port', emopia, tsong)):
        lead, full = _corpora(pkg, s, key, flags, dict(tempo_conti=True))
        outs[tag] = (pkg.corpus_to_leadsheet(lead, 'Positive', **emit),
                     pkg.corpus_to_stage2(lead, full, 'Q3', **emit),
                     pkg.corpus_to_fullsong(full, 'Q1', **emit))
    assert typed(outs['port']) == typed(outs['jax'])
    for got, want in zip(outs['port'], outs['jax']):
        assert events_to_strs(got[-1]) == [f"{e['name']}_{e['value']}" for e in want[-1]]
    lead_evs = events_to_strs(outs['port'][0][1])
    assert ('Key_' in lead_evs[1]) == (rep == 'functional')
    assert lead_evs[-1] == 'EOS_None'


def test_constants_and_find_key_match_jax(tmp_path):
    assert emopia.SIMPLIFY_QUALITY == jax_emopia.SIMPLIFY_QUALITY
    assert (emopia.NONE_CHORD, emopia.CONTI_CHORD) == \
        (jax_emopia.NONE_CHORD, jax_emopia.CONTI_CHORD)
    path = tmp_path / 'key_mode_tempo.csv'
    path.write_text(',clip_name,keyname,mode,tempo\n'
                    + ''.join(f'{i},Q{1 + i % 4}_c{i},{k},0,100\n'
                              for i, k in enumerate(['C', 'a', 'F#', 'c#', 'G'])))
    assert typed(emopia.find_key_emopia(str(path))) == \
        typed(jax_emopia.find_key_emopia(str(path)))


# ---------------------------------------------------------------- the CLIs

@pytest.fixture(scope='module')
def data_homes(tmp_path_factory):
    """The three datasets' inputs (``chip_smoke.write_tokenizer_inputs`` at
    SMALL sizes)."""
    saved = {k: getattr(chip_smoke, k) for k in SMALL}
    for k, v in SMALL.items():
        setattr(chip_smoke, k, v)
    try:
        return chip_smoke.write_tokenizer_inputs(
            str(tmp_path_factory.mktemp('homes')), np.random.RandomState(5))
    finally:
        for k, v in saved.items():
            setattr(chip_smoke, k, v)


def _tokenize(homes, out, dataset, etype, rep, port):
    home = [h for d, h, *_ in chip_smoke.TOKENIZE_RUNS if d == dataset][0]
    args = ['-d', dataset, '-r', rep, '-e', etype, '--data_home', homes[home],
            '--out_root', out]
    if port:
        assert port_main(['midi2events'] + args) == 0
    else:
        jax_midi2events.main(args)


@pytest.mark.parametrize('rep', ['functional', 'remi'])
@pytest.mark.parametrize('run', [f'{d}-{e}' for d, _, e, _ in chip_smoke.TOKENIZE_RUNS])
def test_midi2events_cli_matches_jax(run, rep, data_homes, tmp_path):
    """Both packages' ``midi2events`` over one data home write the same
    files, pickled byte for byte; the unusable HookTheory clips are
    skipped."""
    homes, unusable = data_homes
    dataset, etype = run.split('-')
    corpus = [c for d, _, e, c in chip_smoke.TOKENIZE_RUNS
              if (d, e) == (dataset, etype)][0].format(rep)
    dirs = {}
    for tag in ('jax', 'port'):
        _tokenize(homes, str(tmp_path / tag), dataset, etype, rep, tag == 'port')
        dirs[tag] = tmp_path / tag / corpus / 'events'
    names = sorted(os.listdir(dirs['jax']))
    assert sorted(os.listdir(dirs['port'])) == names
    assert len(names) == {'emopia': SMALL['TOK_CLIPS'], 'pop1k7': SMALL['TOK_POP_SONGS'],
                          'hooktheory': SMALL['TOK_HT_CLIPS'] - len(unusable)}[dataset]
    assert not {n[:-4] for n in names} & set(unusable)
    for name in names:
        got, want = (dirs[t].joinpath(name).read_bytes() for t in ('port', 'jax'))
        assert got == want, name
        assert typed(pickle.loads(got)) == typed(pickle.loads(want))


@pytest.mark.parametrize('etype', ['lead', 'lead2full'])
def test_port_pickles_feed_jax_datasets(etype, data_homes, tmp_path):
    """JAX's stage-1 / stage-2 dataset over the port's EMOPIA+ pickles gives
    the samples it gives over its own."""
    homes, _ = data_homes
    stage, cls, layout, pos = (
        ('stage1', JaxStage1Dataset, 'lead_sheet', 1) if etype == 'lead'
        else ('stage2', JaxStage2Dataset, 'full_song', 2))
    datasets = []
    for tag in ('jax', 'port'):
        _tokenize(homes, str(tmp_path / tag), 'emopia', etype, 'functional', tag == 'port')
        root = tmp_path / tag / stage / 'emopia_events' / f'{layout}_chord11_functional'
        vocab = JaxVocab.load(build_dictionary_from_dir(
            str(root), event_pos=pos, relative=True, add_velocity=etype != 'lead',
            add_tempo=etype != 'lead', num_emotion=2 if etype == 'lead' else 4))
        datasets.append(cls(str(root / 'events'), vocab, model_dec_seqlen=256))
    want, got = datasets
    assert len(got) == len(want) == SMALL['TOK_CLIPS']
    for i in range(len(want)):
        for a, b in zip(dataclasses.astuple(got[i]), dataclasses.astuple(want[i])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_data_splits_cli_matches_jax(data_homes, tmp_path):
    """``data-splits`` through both CLIs over one EMOPIA+ split directory
    and one tokenized HookTheory corpus: the same split pickles."""
    homes, _ = data_homes
    _tokenize(homes, str(tmp_path / 'events'), 'hooktheory', 'lead', 'functional', True)
    ht = tmp_path / 'events/stage1/hooktheory_events/lead_sheet_chord11_functional/events'
    args = ['--emopia_split_dir', os.path.join(homes['EMOPIA+'], 'split'),
            '--hooktheory_events_dir', str(ht)]
    assert port_main(['data-splits'] + args + ['--root', str(tmp_path / 'port')]) == 0
    jax_data_splits.main(args + ['--root', str(tmp_path / 'jax')])
    n = 0
    for stage in ('stage1/emopia_events', 'stage2/emopia_events',
                  'stage1/hooktheory_events'):
        for split in ('train', 'valid'):
            rel = os.path.join('events', stage, 'data_splits', f'{split}.pkl')
            got = (tmp_path / 'port' / rel).read_bytes()
            assert got == (tmp_path / 'jax' / rel).read_bytes(), rel
            n += len(pickle.loads(got))
    assert n == 2 * SMALL['TOK_CLIPS'] + len(os.listdir(ht))
