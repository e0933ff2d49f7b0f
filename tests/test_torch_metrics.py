"""The port's objective metrics (``infer/metrics.py``) and ``evaluate`` CLI
(copies, not imports) against the JAX package's: equal profiles on streams
of both note layouts (absolute ``Note_Pitch`` and functional
``Note_Octave`` + ``Note_Degree``), and the same report on one directory."""

import json
import os
import pickle

import numpy as np
import pytest

from emo_disentanger_tpu.cli import evaluate as jeval
from emo_disentanger_tpu.infer import metrics as jmetrics
from emo_disentanger_tpu.infer import pipeline as jpipe
from emo_disentanger_tpu_torch.cli import evaluate as teval
from emo_disentanger_tpu_torch.infer import metrics as tmetrics
from helpers import write_stage2_corpus

FUNCTIONS = ('find_key', 'scale_consistency', 'note_density', 'mean_velocity',
             'mean_tempo', 'pitch_range', 'groove_consistency', 'mode_label',
             'emotion_profile')


@pytest.fixture(scope='module')
def streams(tmp_path_factory):
    """Functional streams of the stage-2 corpus, their absolute
    renderings, seeded shuffles of both and degenerate streams."""
    root = str(tmp_path_factory.mktemp('corpus'))
    events_dir, _, names = write_stage2_corpus(root, n_pieces=4)
    out = []
    for name in names:
        with open(os.path.join(events_dir, name), 'rb') as f:
            evs = ['{}_{}'.format(e['name'], e['value'])
                   for e in pickle.load(f)[2]]
        out += [evs, jpipe.roman_events_to_absolute(evs[1], evs)]
    rng = np.random.RandomState(0)
    for s in list(out):
        body = list(s[3:])
        rng.shuffle(body)
        out.append(s[:3] + body)
    out += [[], ['Key_g#', 'Note_Degree_I'], ['Bar_None'],
            ['Key_c', 'Bar_None', 'Note_Octave_5', 'Note_Degree_XX',
             'Note_Pitch_30', 'Tempo_Conti', 'Tempo_60', 'Beat_3'],
            ['Bar_None', 'Beat_0', 'Bar_None', 'Beat_15', 'Bar_None']]
    return out


@pytest.mark.parametrize('name', FUNCTIONS)
def test_metric_matches_jax(streams, name):
    for s in streams:
        assert getattr(tmetrics, name)(s) == getattr(jmetrics, name)(s), s[:4]
    if name in ('scale_consistency', 'pitch_range'):
        for s in streams[:4]:
            for key in ('C', 'a', 'F#'):
                assert getattr(tmetrics, name)(s, key) == \
                    getattr(jmetrics, name)(s, key)


def test_functional_layout_pitches(streams):
    """The functional stream and its absolute rendering give the same
    pitch-derived metrics (the layout fix of ``_abs_pitches``)."""
    for rel, absolute in zip(streams[0:8:2], streams[1:8:2]):
        for name in ('scale_consistency', 'pitch_range', 'note_density'):
            assert getattr(tmetrics, name)(rel) == getattr(tmetrics, name)(absolute)
        assert tmetrics.scale_consistency(rel) > 0


def test_evaluate_dir_matches_jax(streams, tmp_path, capsys):
    labels = ['Positive', 'Negative', 'Positive_Q1', 'Negative_Q3', 'Q2', 'Q4',
              'None']
    for i, s in enumerate(streams[:14]):
        tag = labels[i % len(labels)]
        with open(tmp_path / f'samp_{i:02d}_{tag}.txt', 'w') as f:
            f.write('\n'.join(s) + '\n')
        with open(tmp_path / f'samp_{i:02d}_{tag}_roman.txt', 'w') as f:
            f.write('Key_C\n')
    open(tmp_path / 'samp_99_Positive.txt', 'w').close()       # empty: skipped
    want = jeval.evaluate_dir(str(tmp_path))
    assert teval.evaluate_dir(str(tmp_path)) == want
    assert set(want) == {'Positive', 'Negative', 'Q1', 'Q2', 'Q3', 'Q4'}
    assert teval.evaluate_dir(str(tmp_path), '_roman.txt') == \
        jeval.evaluate_dir(str(tmp_path), '_roman.txt')
    capsys.readouterr()
    report = teval.main(['-o', str(tmp_path)])
    assert json.loads(capsys.readouterr().out) == report == want
