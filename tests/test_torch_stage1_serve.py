"""Stage-1 generation of the PyTorch port (CPU) against the JAX package.

At ``top_p=0`` the nucleus keeps only the most probable token, so both
frameworks' generators are deterministic whatever their random streams.
The primers already hold their ``Key_*`` token, so the key step (which
samples at top-p 0.97 whatever ``top_p`` is) never fires, and the lockstep
``generate`` (through its cache ladder), ``serve`` and ``Stage1Generator``
must give JAX's token streams, statuses, bar counts and reject counts
exactly.  A cross-framework near-tie could flip a token silently, so every
step's logits are recorded and each sampling row's top-2 gap must exceed
ten times LOGIT_TOL, the logits' cross-framework agreement
(``test_torch_txl.py``).  The reference-exact replay, driven by the numpy
sampler, must give JAX's replay token for token.  On the port alone: the
ladder's sampled streams equal the single-tier run's bitwise, and the
rules hold on sampled streams."""

import jax
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.infer.reference_exact import (
    generate_stage1_reference_exact as jax_replay)
from emo_disentanger_tpu.infer.stage1 import Stage1Generator as JaxSingle
from emo_disentanger_tpu.infer.stage1_batch import (
    Stage1BatchGenerator as JaxBatch)
from emo_disentanger_tpu_torch.core.vocab import Vocab
from emo_disentanger_tpu_torch.infer import stage1 as port_stage1
from emo_disentanger_tpu_torch.infer.reference_exact import (
    generate_stage1_reference_exact)
from emo_disentanger_tpu_torch.infer.stage1 import (
    STATUS_DONE, STATUS_OVERFLOW, STATUS_RUNNING, STATUS_STUCK,
    Stage1Generator)
from emo_disentanger_tpu_torch.infer.stage1_batch import Stage1BatchGenerator
from test_torch_txl import txl_pair
from tests_vocab_helper import tiny_vocab2
from torch_port_helpers import one_torch_thread  # noqa: F401

LOGIT_TOL = 2e-5

PRIMERS = [
    ['Emotion_Q1', 'Key_C', 'Bar_None', 'Beat_0', 'Chord_I_M',
     'Note_Octave_5', 'Note_Degree_I', 'Note_Duration_480'],
    ['Emotion_Q2', 'Key_c', 'Bar_None', 'Beat_4', 'Chord_V_7'],
    ['Emotion_Q2', 'Key_c', 'Bar_None', 'Beat_2', 'Note_Octave_5',
     'Note_Degree_V', 'Note_Duration_480', 'Beat_8'],
    ['Emotion_Q1', 'Key_C', 'Bar_None'],
]
EMOTIONS = ['Q1', 'Q2', 'Q2', 'Q1']
TARGETS = [3, 4, 8, 8]
# max_events 40, caches [56, 104]: rejecting songs outgrow the first tier
KW = dict(temp=1.2, max_events=40, max_bars=8, reject_slack=64)

# head biases: PAD and EOS never win; the Beat and Bar offsets pick, per
# weight seed, a mix of final statuses and rejections
CASES = {
    'bars-done-overflow': dict(seed=3, beat=0.0, bar=1.0,
                               want=(STATUS_RUNNING, STATUS_DONE, STATUS_OVERFLOW)),
    'rejects-overflow': dict(seed=4, beat=0.5, bar=0.5,
                             want=(STATUS_DONE, STATUS_OVERFLOW)),
}


def _port_vocab(jv):
    ev = {e: i for e, i in jv.event2idx.items() if e != 'PAD_None'}
    return Vocab(ev, {i: e for e, i in ev.items()})


def _models(jv, case):
    def bias(b):
        b[jv.pad_id] = b[jv.event2idx['EOS_None']] = -30.0
        b[[jv.event2idx[f'Beat_{k}'] for k in range(16)]] += case['beat']
        b[jv.event2idx['Bar_None']] += case['bar']
    return txl_pair(jv.size, seed=case['seed'], std=0.1, bias_fn=bias)


class _Recorder:
    """Records every step's logits as the sampler sees them and the rows
    that sample at that step (running, past the primer)."""

    def __init__(self, monkeypatch, gen):
        self.logits, self.rows = [], []
        real_sample, real_step = port_stage1.nucleus_sample, gen._step

        def sample(logits, *a, **kw):
            self.logits.append(logits.clone())
            return real_sample(logits, *a, **kw)

        def step(s, *a, **kw):
            self.rows.append(gen._running(s) & (s['fed'] >= s['primer_len']))
            real_step(s, *a, **kw)
        monkeypatch.setattr(port_stage1, 'nucleus_sample', sample)
        monkeypatch.setattr(gen, '_step', step)

    def min_gap(self) -> float:
        gaps = [float((top[:, 0] - top[:, 1])[rows].min())
                for lg, rows in zip(self.logits, self.rows) if rows.any()
                for top in [lg.topk(2).values]]
        assert len(gaps) > 20
        return min(gaps)


def _same(jres, tres, keys=('status', 'bars', 'events', 'rejects')):
    (js, jst), (ts, tst) = jres, tres
    assert ts == js
    for key in keys:
        assert tst[key] == jst[key], key


@pytest.mark.parametrize('name', sorted(CASES))
def test_generate_ladder_matches_jax_greedy(name, monkeypatch):
    case = CASES[name]
    jv = tiny_vocab2()
    jm, params, tm = _models(jv, case)
    kw = dict(KW, batch=4, top_p=0.0, fast_slack=16)
    jgen = JaxBatch(jm, params, jv, **kw)
    tgen = Stage1BatchGenerator(tm, _port_vocab(jv), device='cpu', **kw)
    rec = _Recorder(monkeypatch, tgen)
    tres = tgen.generate(EMOTIONS, seed=11, primers=PRIMERS, target_bars=TARGETS)
    jres = jgen.generate(EMOTIONS, seed=3, primers=PRIMERS, target_bars=TARGETS)
    _same(jres, tres, ('status', 'bars', 'events', 'rejects', 'resumed'))
    assert set(case['want']) <= set(tres[1]['status'])
    assert tres[1]['resumed'] >= 1
    assert rec.min_gap() > 10 * LOGIT_TOL


@pytest.mark.parametrize('name', sorted(CASES))
def test_serve_matches_jax_greedy(name, monkeypatch):
    """6 jobs through 4 slots with per-slot clocks and refills."""
    case = CASES[name]
    jv = tiny_vocab2()
    jm, params, tm = _models(jv, case)
    kw = dict(KW, batch=4, top_p=0.0)
    emotions, primers = EMOTIONS + EMOTIONS[:2], PRIMERS + PRIMERS[2:]
    targets = TARGETS + [5, 2]
    jgen = JaxBatch(jm, params, jv, **kw)
    tgen = Stage1BatchGenerator(tm, _port_vocab(jv), device='cpu', **kw)
    rec = _Recorder(monkeypatch, tgen)
    tres = tgen.serve(emotions, seed=11, primers=primers, target_bars=targets,
                      chunk_steps=16)
    jres = jgen.serve(emotions, seed=3, primers=primers, target_bars=targets,
                      chunk_steps=16)
    _same(jres, tres)
    assert tres[1]['chunks'] >= 2
    assert rec.min_gap() > 10 * LOGIT_TOL


def test_single_song_generator_matches_jax_greedy(monkeypatch):
    jv = tiny_vocab2()
    jm, params, tm = _models(jv, CASES['rejects-overflow'])
    jgen = JaxSingle(jm, params, jv, top_p=0.0, **KW)
    tgen = Stage1Generator(tm, _port_vocab(jv), top_p=0.0, device='cpu', **KW)
    rec = _Recorder(monkeypatch, tgen)
    for primer, emotion, target in zip(PRIMERS[1:3], EMOTIONS[1:3], (4, 8)):
        tev, tst = tgen.generate(emotion, 1, primer_events=primer,
                                 target_bars=target)
        jev, jst = jgen.generate(emotion, 0, primer_events=primer,
                                 target_bars=target)
        assert tev == jev
        assert {k: tst[k] for k in ('status', 'bars', 'n_events')} == \
            {k: jst[k] for k in ('status', 'bars', 'n_events')}
    assert rec.min_gap() > 10 * LOGIT_TOL


@pytest.mark.parametrize('primer', ['emotion-only', 'prompt'])
def test_reference_exact_replay_matches_jax(primer):
    """The numpy-sampled replay at 1.2 / 0.97 under one np.random seed.
    Emotion-only primers run the key step, which must draw a Key_* token:
    the head favours the two keys, and the weight and numpy seeds are ones
    whose key step draws a key."""
    jv = tiny_vocab2()
    keys = [jv.event2idx['Key_C'], jv.event2idx['Key_c']]
    emotion_only = primer == 'emotion-only'

    def bias(b):
        b[jv.event2idx['EOS_None']] = -30.0
        if emotion_only:
            b[keys] += 4.0
    jm, params, tm = txl_pair(jv.size, seed=7 if emotion_only else 6,
                              std=0.1, bias_fn=bias)
    events = ['Emotion_Q2'] if emotion_only else PRIMERS[1]
    kw = dict(primer_events=events, max_bars=6, max_events=30, max_klen=128)
    np_seed = 26 if emotion_only else 21
    np.random.seed(np_seed)
    want, wsteps = jax_replay(jm, params, jv, **kw)
    np.random.seed(np_seed)
    got, gsteps = generate_stage1_reference_exact(tm, _port_vocab(jv), **kw)
    assert got == want and gsteps == wsteps
    assert len(got) > 20
    assert jv.idx2event[got[1]] == ('Key_c' if emotion_only else 'Key_c')


def _check_rules(songs, emotions):
    for song, emotion in zip(songs, emotions):
        assert song is not None and song[0] == f'Emotion_{emotion}'
        assert song[1] == ('Key_C' if emotion == 'Q1' else 'Key_c')
        assert 'PAD_None' not in song
        cur = 0
        for ev in song[2:]:
            if ev == 'Bar_None':
                cur = 0
            elif ev.startswith('Beat_'):
                assert int(ev.split('_')[1]) >= cur, song
                cur = int(ev.split('_')[1])


def test_ladder_equals_single_tier_sampled_and_rules_hold():
    """Sampled (temp 1.2, top-p 0.97) emotion-only songs: the ladder run
    and the single-tier run give the same songs and counts bitwise, and the
    key step drew the valence's mode."""
    jv = tiny_vocab2()

    def bias(b):
        b[[jv.event2idx['Key_C'], jv.event2idx['Key_c']]] += 3.0
    _, _, tm = txl_pair(jv.size, seed=2, std=0.1, bias_fn=bias)
    vocab = _port_vocab(jv)
    emotions = ['Q1', 'Q2', 'Q1', 'Q2']
    kw = dict(KW, batch=4, top_p=0.97, device='cpu')
    ladder = Stage1BatchGenerator(tm, vocab, fast_slack=0, **kw)
    single = Stage1BatchGenerator(tm, vocab, fast_slack=None, **kw)
    assert ladder.klens == [40, 104] and single.klens == [104]
    ls, lst = ladder.generate(emotions, seed=5, target_bars=6)
    ss, sst = single.generate(emotions, seed=5, target_bars=6)
    assert ls == ss
    for key in ('status', 'bars', 'events', 'rejects'):
        assert lst[key] == sst[key], key
    assert lst['resumed'] >= 1 and sst['resumed'] == 0
    assert sum(lst['rejects']) > 0
    _check_rules(ls, emotions)
    served, _ = single.serve(emotions * 2, seed=6, target_bars=6)
    _check_rules(served, emotions * 2)


def test_stuck_song_returns_none(monkeypatch):
    """A scripted sampler draws Beat_15 for eight steps (the batch's seven
    primer steps and its first sampled one) and Beat_0 from then on: 256
    rejections in a row mark the song STUCK, and it comes back as None."""
    jv = tiny_vocab2()
    _, _, tm = txl_pair(jv.size, seed=1)
    vocab = _port_vocab(jv)
    b15, b0 = jv.event2idx['Beat_15'], jv.event2idx['Beat_0']
    draws = []

    def scripted(logits, *a, **kw):
        draws.append(1)
        tok = b15 if len(draws) <= 8 else b0
        return torch.full((logits.shape[0],), tok, dtype=torch.long)
    monkeypatch.setattr(port_stage1, 'nucleus_sample', scripted)
    gen = Stage1BatchGenerator(tm, vocab, batch=2, max_events=40, max_bars=8,
                               reject_slack=400, device='cpu')
    songs, stats = gen.generate(['Q2', 'Q1'], seed=0,
                                primers=[PRIMERS[2], PRIMERS[0]])
    assert songs == [None, None] and stats['status'] == [STATUS_STUCK] * 2
    assert stats['rejects'] == [256, 256]
    draws.clear()
    single = Stage1Generator(tm, vocab, max_events=40, reject_slack=400,
                             device='cpu')
    song, st = single.generate('Q2', 0, primer_events=PRIMERS[2])
    assert song is None and st['status'] == STATUS_STUCK


def test_mesh_of_many_devices_is_refused():
    jv = tiny_vocab2()
    _, _, tm = txl_pair(jv.size)

    class Mesh:
        size = 4
    with pytest.raises(NotImplementedError, match='one device'):
        Stage1BatchGenerator(tm, _port_vocab(jv), batch=2, mesh=Mesh(),
                             device='cpu')
