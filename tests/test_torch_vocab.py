"""The port's vocabulary and rule tables (copies, not imports) against the
JAX package's: equal dictionaries, equal loaded vocabularies and equal
lookup tables, exactly."""

import os
import pickle

import numpy as np
import pytest

from emo_disentanger_tpu.core import vocab as jvocab
from emo_disentanger_tpu.infer import rules as jrules
from emo_disentanger_tpu_torch.core import vocab as tvocab
from emo_disentanger_tpu_torch.infer import rules as trules

CORPUS = (['Bar_None', 'EOS_None', 'Track_LeadSheet', 'Track_Full',
           {'name': 'Beat', 'value': 3}]
          + [f'Beat_{b}' for b in range(16)]
          + [f'Key_{k}' for k in ('C', 'F#', 'a', 'c#', 'g')])


@pytest.mark.parametrize('kw', [
    dict(), dict(add_velocity=True, relative=True),
    dict(num_emotion=2, add_tempo=False), dict(add_emotion=False)],
    ids=['default', 'velocity-relative', 'two-emotions', 'no-emotion'])
def test_events_to_dictionary_matches_jax(kw):
    want = jvocab.events_to_dictionary([CORPUS], **kw)
    assert tvocab.events_to_dictionary([CORPUS], **kw) == want
    assert tvocab.build_full_vocab(**{k: v for k, v in kw.items()}) == \
        jvocab.build_full_vocab(**kw)


def test_dictionary_file_and_load_match_jax(tmp_path):
    os.mkdir(tmp_path / 'events')
    for i in range(2):
        with open(tmp_path / 'events' / f'song{i}.pkl', 'wb') as f:
            pickle.dump((None, None, CORPUS[i::2]), f)
    path = tvocab.build_dictionary_from_dir(str(tmp_path), relative=True)
    got = tvocab.Vocab.load(path)
    jpath = jvocab.build_dictionary_from_dir(str(tmp_path), relative=True)
    want = jvocab.Vocab.load(jpath)
    assert (got.event2idx, got.idx2event, got.pad_id, got.size) == \
        (want.event2idx, want.idx2event, want.pad_id, want.size)
    ev = ['Bar_None', {'name': 'Beat', 'value': 3}, 'Track_Full']
    assert got.encode(ev) == want.encode(ev)
    assert got.decode(got.encode(ev)) == want.decode(want.encode(ev))
    assert (got.bar_id, got.eos_id) == (want.bar_id, want.eos_id)


def test_rule_tables_match_jax():
    e2w, w2e = jvocab.events_to_dictionary([CORPUS], relative=True)
    want = jrules.build_rule_tables(jvocab.Vocab(e2w, w2e))
    got = trules.build_rule_tables(tvocab.Vocab(e2w, w2e))
    for field in ('is_beat', 'beat_pos', 'is_bar', 'is_pad', 'is_eos',
                  'is_key', 'key_major', 'is_track_lead', 'is_track_full'):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.key_major.sum() == 2 and got.is_beat.sum() == 16


@pytest.mark.parametrize('emotion', ['Positive', 'Negative', 'Q1', 'Q2',
                                     'Q3', 'Q4'])
def test_emotion_wants_major_matches_jax(emotion):
    assert trules.emotion_wants_major(emotion) == \
        jrules.emotion_wants_major(emotion)


def test_emotion_wants_major_rejects_unknown():
    with pytest.raises(ValueError, match='unknown emotion'):
        trules.emotion_wants_major('Q5')
