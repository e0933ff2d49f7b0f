"""The port's stage-1 <-> stage-2 glue (``infer/pipeline.py``) and MIDI
rendering (``infer/convert2midi.py``), copies, not imports, against the
JAX package's: every function gives the same result on the streams of
``tests/helpers.write_stage2_corpus`` and on hand-written degenerate ones,
and ``events_to_midi`` writes byte-identical files in both modes, with and
without the chord track and the enforced tempo.  Also ``infer/audio.py``'s
two error paths."""

import os
import pickle

import numpy as np
import pytest

from emo_disentanger_tpu.core.vocab import Vocab as JaxVocab
from emo_disentanger_tpu.infer import convert2midi as jconv
from emo_disentanger_tpu.infer import pipeline as jpipe
from emo_disentanger_tpu_torch.core.theory import MAJOR_KEY, MINOR_KEY
from emo_disentanger_tpu_torch.infer import audio as taudio
from emo_disentanger_tpu_torch.infer import convert2midi as tconv
from emo_disentanger_tpu_torch.infer import pipeline as tpipe
from helpers import write_stage2_corpus

DEGENERATE = {
    # a Degree before any Octave defaults to octave 5
    'degree-first': ['Key_C', 'Bar_None', 'Beat_0', 'Note_Degree_V',
                     'Note_Duration_480', 'Note_Octave_3', 'Note_Degree_I#'],
    'minor-chords': ['Key_a', 'Bar_None', 'Beat_0', 'Chord_II#_m', 'Chord_V#_7',
                     'Chord_Conti_Conti', 'Chord_None_None', 'Note_Octave_9',
                     'Note_Degree_VII', 'Note_Octave_1', 'Note_Degree_I'],
    'bare-key': ['e', 'Bar_None', 'Chord_IV_sus4', 'Note_Octave_4',
                 'Note_Degree_II'],
    'empty': [],
}


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """(streams as event strings, their keys, the stage-2 vocabulary)."""
    root = str(tmp_path_factory.mktemp('corpus'))
    events_dir, vocab_path, names = write_stage2_corpus(root, n_pieces=4)
    streams = []
    for name in names:
        with open(os.path.join(events_dir, name), 'rb') as f:
            evs = pickle.load(f)[2]
        streams.append(['{}_{}'.format(e['name'], e['value']) for e in evs])
    return streams, [s[1] for s in streams], JaxVocab.load(vocab_path)


def _abs_streams(corpus):
    streams, keys, _ = corpus
    return [(k, jpipe.roman_events_to_absolute(k, s)) for s, k in zip(streams, keys)]


def test_roman_and_extract_match_jax(corpus):
    streams, keys, _ = corpus
    cases = list(zip(keys, streams)) + [
        (s[0] if s else 'Key_C', s) for s in DEGENERATE.values()]
    for key, stream in cases:
        assert tpipe.roman_events_to_absolute(key, stream) == \
            jpipe.roman_events_to_absolute(key, stream)
        for rel in (False, True):
            assert tpipe.extract_midi_events_from_generation(key, stream, rel) == \
                jpipe.extract_midi_events_from_generation(key, stream, rel)
    assert tpipe.roman_events_to_absolute('Key_C', DEGENERATE['degree-first'])[3] \
        == 'Note_Pitch_67'


def test_merge_tracks_matches_jax(corpus):
    rng = np.random.RandomState(0)
    streams = corpus[0]
    for s in streams:
        bars = jpipe.extract_midi_events_from_generation(s[1], s)
        for bar in bars:
            melody = ['Track_M', 'Emotion_Q1', 'Key_C', 'Bar_None'] + bar
            chord = ['Track_C', 'Bar_None'] + [
                e for e in bar if e.startswith(('Beat', 'Chord'))]
            rng.shuffle(chord[2:])
            assert tpipe.merge_tracks(melody, chord) == \
                jpipe.merge_tracks(melody, chord)
    assert tpipe.merge_tracks(['a', 'b', 'c'], ['x']) == \
        jpipe.merge_tracks(['a', 'b', 'c'], ['x'])


def test_text_files_match_jax(corpus, tmp_path, capsys):
    """events_to_txt writes the same text; read_generated_events reads a
    written stream, a key outside the vocabulary (Key_C, with the warning),
    a stream without a key and an empty file alike."""
    streams, _, vocab = corpus
    files = {'stream': streams[0][1:]}
    files.update({'unknown-key': ['Key_F#'] + streams[1][2:],
                  'no-key': streams[2][3:], 'empty': []})
    for name, events in files.items():
        tpath, jpath = str(tmp_path / f'{name}_t.txt'), str(tmp_path / f'{name}_j.txt')
        tpipe.events_to_txt(events, tpath)
        jpipe.events_to_txt(events, jpath)
        assert open(tpath).read() == open(jpath).read()
        capsys.readouterr()
        got = tpipe.read_generated_events(tpath, vocab.event2idx)
        t_out = capsys.readouterr().out
        want = jpipe.read_generated_events(jpath, vocab.event2idx)
        assert got == want and t_out == capsys.readouterr().out
        if name == 'unknown-key':
            assert got[0] == 'Key_C' and 'Key_F#' in t_out


@pytest.mark.parametrize('tempo', [32, 60, 110, 180, 224])
def test_inadmissible_set_matches_jax(corpus, tempo):
    vocab = corpus[2]
    for tol in (0, 20, 50):
        got = tpipe.construct_inadmissible_set(tempo, vocab.event2idx, vocab.size, tol)
        want = jpipe.construct_inadmissible_set(tempo, vocab.event2idx, vocab.size, tol)
        assert got.dtype == want.dtype and (got == want).all()
        tempos = {idx: int(ev.split('_')[1]) for ev, idx in vocab.event2idx.items()
                  if ev.startswith('Tempo_') and 'Conti' not in ev}
        assert sorted(np.flatnonzero(got)) == sorted(
            idx for idx, t in tempos.items() if abs(t - tempo) > tol)


def test_emotion_candidates_match_jax():
    for name in ('out/samp_00_Positive_roman.txt', 'samp_01_Negative.txt',
                 'Q3_x.txt', 'samp_None.txt', 'Q1_Positive.txt'):
        assert tpipe.emotion_candidates_for_file(name) == \
            jpipe.emotion_candidates_for_file(name)
    for mod in (tpipe, jpipe):
        with pytest.raises(ValueError, match='wrong emotion label'):
            mod.emotion_candidates_for_file('samp_00.txt')


RENDER = [(mode, chords, tempo) for mode in ('lead_sheet', 'full_song', 'skyline', 'full')
          for chords in (False, True) for tempo in (False, True)]


@pytest.mark.parametrize('mode,play_chords,enforce_tempo', RENDER)
def test_events_to_midi_bytes_match_jax(corpus, tmp_path, mode, play_chords,
                                        enforce_tempo):
    for i, (key, events) in enumerate(_abs_streams(corpus)):
        for evs in (events, jpipe.extract_midi_events_from_generation(key, events)[0]):
            kw = dict(play_chords=play_chords, enforce_tempo=enforce_tempo)
            if enforce_tempo and i % 2:
                kw['enforce_tempo_evs'] = [tconv.TempoEvent(110, 0, 0)]
            tpath, jpath = str(tmp_path / 't.mid'), str(tmp_path / 'j.mid')
            got = tconv.events_to_midi(key, evs, mode, output_midi_path=tpath, **kw)
            if 'enforce_tempo_evs' in kw:
                kw['enforce_tempo_evs'] = [jconv.TempoEvent(110, 0, 0)]
            want = jconv.events_to_midi(key, evs, mode, output_midi_path=jpath, **kw)
            assert open(tpath, 'rb').read() == open(jpath, 'rb').read()
            assert got.to_bytes() == want.to_bytes()
    enum = tconv.RenderMode.parse(mode)
    assert tconv.events_to_midi('Key_c', [], enum).to_bytes() == \
        jconv.events_to_midi('Key_c', [], jconv.RenderMode.parse(mode)).to_bytes()


def test_chords_match_jax():
    assert tconv.CHORD_MAPS == jconv.CHORD_MAPS
    for root in list(MAJOR_KEY):
        for quality in tconv.CHORD_MAPS:
            chord = f'{root}_{quality}'
            assert tconv.chord_to_pitches(chord) == jconv.chord_to_pitches(chord)
    with pytest.raises(KeyError):
        tconv.chord_to_pitches(f'{MINOR_KEY[0]}_M')
    for mod in (tconv, jconv):
        with pytest.raises(KeyError):
            mod.RenderMode.parse('remi')


def test_midi_to_wav_errors(monkeypatch, tmp_path):
    monkeypatch.setattr(taudio.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='fluidsynth'):
        taudio.midi_to_wav('x.mid', 'x.wav')
    monkeypatch.setattr(taudio.shutil, 'which', lambda name: '/bin/true')
    with pytest.raises(FileNotFoundError, match='soundfont'):
        taudio.midi_to_wav('x.mid', 'x.wav',
                           sound_font_path=str(tmp_path / 'none.sf2'))
