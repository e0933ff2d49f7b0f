"""The port's stage-2 dataset against the JAX package's on a synthetic corpus:
the same ``RandomState`` draws give identical samples and shuffled batches,
and ``neutralize_pad_rows`` pads short batches identically."""

import numpy as np
import pytest

from helpers import write_stage2_corpus

from emo_disentanger_tpu.core.vocab import Vocab as JaxVocab
from emo_disentanger_tpu.data.datasets import Stage2Dataset as JaxDataset
from emo_disentanger_tpu.train.train_stage1 import neutralize_pad_rows as jax_neutralize
from emo_disentanger_tpu_torch.core.vocab import Vocab
from emo_disentanger_tpu_torch.data.datasets import Stage2Dataset
from emo_disentanger_tpu_torch.train.trainer import neutralize_pad_rows

# short enough that every piece is longer and samples a random start bar
SEQLEN = 48


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    return write_stage2_corpus(str(tmp_path_factory.mktemp('s2')), n_pieces=5)


def _pair(corpus, seed):
    events_dir, vocab_path, _ = corpus
    return (JaxDataset(events_dir, JaxVocab.load(vocab_path),
                       model_dec_seqlen=SEQLEN, seed=seed),
            Stage2Dataset(events_dir, Vocab.load(vocab_path),
                          model_dec_seqlen=SEQLEN, seed=seed))


def test_samples_equal_jax(corpus):
    jd, td = _pair(corpus, seed=3)
    assert len(td) == len(jd) == 5
    assert td.admissible_st_bars == jd.admissible_st_bars
    assert any(len(a) > 1 for a in td.admissible_st_bars)
    for _ in range(3):                  # the start bars follow the rng
        for i in range(len(jd)):
            a, b = jd[i], td[i]
            for field in ('dec_inp', 'dec_tgt', 'track_mask', 'chord_idx',
                          'melody_idx'):
                np.testing.assert_array_equal(getattr(b, field),
                                              getattr(a, field), err_msg=field)
            assert (b.length, b.piece_id) == (a.length, a.piece_id)
            assert b.dec_tgt.dtype == a.dec_tgt.dtype


def test_shuffled_batches_equal_jax(corpus):
    jd, td = _pair(corpus, seed=4)
    for _ in range(2):                  # two epochs of shuffles
        jb = list(jd.batches(2, shuffle=True))
        tb = list(td.batches(2, shuffle=True))
        assert len(tb) == len(jb) == 3
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_neutralize_pad_rows_matches_jax(corpus):
    _, td = _pair(corpus, seed=5)
    short = list(td.batches(3, shuffle=False))[-1]      # 2 rows of 3
    assert short['dec_inp'].shape[0] == 2
    want = jax_neutralize(short, 3, td.pad_id)
    got = neutralize_pad_rows(short, 3, td.pad_id)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got['dec_tgt'][2] == td.pad_id).all() and not got['chord_idx'][2].any()
