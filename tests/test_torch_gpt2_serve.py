"""Stage-2 GPT-2 serving: the port (CPU) against the JAX package.

At ``top_p=0`` the nucleus keeps only the most probable token, so both
generators are deterministic whatever their random streams: the batched
``generate`` and ``serve`` and the host-driven ``Stage2Generator`` must give
JAX's streams token for token.  The caches are small (256 positions, a
128-token window, margin 32, as ``tests/test_gpt2_ladder.py``) so the
in-loop window re-anchors fire.  A cross-framework near-tie could flip a
token silently, so every logits row the port samples from is recorded and
its top-2 gap must exceed ten times LOGIT_TOL, the bound the replay through
both forwards holds the two models' logits to.  The ladder is held against
the port's own single-cache run at sampled settings, and the
reference-exact replay against JAX's under one ``np.random`` seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.infer.reference_exact import (
    generate_stage2_reference_exact as jax_reference_exact)
from emo_disentanger_tpu.infer.stage2 import Stage2Generator as JaxHostGenerator
from emo_disentanger_tpu.infer.stage2_batch import (
    Stage2BatchGenerator as JaxGenerator)
from emo_disentanger_tpu_torch.core.vocab import Vocab
from emo_disentanger_tpu_torch.infer import stage2 as ts2
from emo_disentanger_tpu_torch.infer import stage2_batch as ts2b
from emo_disentanger_tpu_torch.infer.reference_exact import (
    generate_stage2_reference_exact)
from tests_vocab_helper import tiny_vocab2
from torch_port_helpers import gpt2_pair, model_pair, one_torch_thread  # noqa: F401

# f32 logits of the two-layer models agree to ~1e-6 across frameworks
LOGIT_TOL = 2e-5
CACHE = dict(gpt2_cache_len=256, gpt2_window=128, reanchor_margin=32)


def _port_vocab(jv):
    ev = {e: i for e, i in jv.event2idx.items() if e != 'PAD_None'}
    return Vocab(ev, {i: e for e, i in ev.items()})


def _jobs(vocab, n, rng, bars=(6, 12)):
    e = vocab.event2idx
    primers, sheets = [], []
    for j in range(n):
        primers.append([e['Emotion_Q1' if j % 2 else 'Emotion_Q2'],
                        e['Key_C' if j % 2 else 'Key_c'], e['Tempo_110']])
        sheet = []
        for _ in range(rng.randint(*bars)):
            beats = sorted(rng.choice(16, size=2, replace=False))
            sheet.append([e['Bar_None'], e[f'Beat_{beats[0]}'], e['Chord_I_M'],
                          e['Note_Octave_5'], e['Note_Degree_I'],
                          e[f'Beat_{beats[1]}'], e['Chord_V_7'],
                          e['Note_Degree_V'], e['Note_Duration_480']])
        sheets.append(sheet)
    return primers, sheets


def _biased_pair(jv, seed, beat, lead):
    """PAD and EOS never win; the beat and Track_LeadSheet offsets pick, per
    weight seed, how songs end and how long they run."""
    beats = [jv.event2idx[f'Beat_{b}'] for b in range(16)]

    def bias(b):
        b[jv.pad_id] = b[jv.event2idx['EOS_None']] = -30.0
        b[beats] += beat
        b[jv.event2idx['Track_LeadSheet']] += lead
    return gpt2_pair(jv.size, seed=seed, std=0.1, bias_fn=bias)


class SampledGaps:
    """Records the top-2 logit gap of every row the port samples from: all
    rows of the host generator's draws; in the batched generator the rows of
    elements that are running and sampling at that step."""

    def __init__(self, monkeypatch):
        self.gaps, self.rows = [], []
        for mod in (ts2, ts2b):
            real = mod.nucleus_sample
            monkeypatch.setattr(mod, 'nucleus_sample', self._wrap(real))
        step = ts2b.Stage2BatchGenerator._step

        def recording_step(gen, s, g):
            self.rows.append((s['status'] == ts2b.STATUS_RUNNING)
                             & (s['mode'] == ts2b.MODE_SAMPLE) & ~s['in_primer'])
            return step(gen, s, g)
        monkeypatch.setattr(ts2b.Stage2BatchGenerator, '_step', recording_step)

    def _wrap(self, real):
        def sample(logits, *args):
            top = logits.topk(2, -1).values
            self.gaps.append(top[:, 0] - top[:, 1])
            return real(logits, *args)
        return sample

    def check(self, batched: bool) -> int:
        gaps = torch.cat(self.gaps)
        if batched:
            gaps = gaps[torch.cat(self.rows)]
        assert float(gaps.min()) > 10 * LOGIT_TOL, float(gaps.min())
        return gaps.numel()


def _replay_agrees(jm, params, tm, jv, streams):
    """Both forwards over the streams (one batch, PAD at the end) agree
    within LOGIT_TOL."""
    L = max(len(s) for s in streams)
    tok = np.full((len(streams), L), jv.pad_id, np.int32)
    for b, s in enumerate(streams):
        tok[b, :len(s)] = s
    seg = (tok % 2).astype(np.int32)
    with torch.no_grad():
        got = tm(torch.from_numpy(tok).long(), torch.from_numpy(seg).long())
    want = jm.apply(params, jnp.asarray(tok), jnp.asarray(seg))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=LOGIT_TOL)


# (weight seed, beat offset, Track_LeadSheet offset, final statuses wanted)
CASES = {
    'stuck-and-max': (5, -0.3, 1.0, (ts2b.STATUS_STUCK, ts2b.STATUS_MAX)),
    'max': (13, -0.5, 0.5, (ts2b.STATUS_MAX,)),
}
KW = dict(temp=1.1, top_p=0.0, max_events=300, max_bar_tokens=32, max_bars=12,
          **CACHE)


def _check_batched(jres, tres, gaps, models, jv):
    (js, jstats), (ts, tstats) = jres, tres
    assert ts == js
    for key in ('status', 'bars', 'rejects', 'events', 'reanchors'):
        assert tstats[key] == jstats[key], key
    assert sum(tstats['reanchors']) >= 1 and sum(jstats['reanchors']) >= 1
    assert gaps.check(batched=True) > 500
    _replay_agrees(*models, jv, ts)


@pytest.mark.parametrize('name', sorted(CASES))
def test_generate_matches_jax_greedy(name, monkeypatch):
    seed, beat, lead, want = CASES[name]
    jv = tiny_vocab2()
    jm, params, tm = _biased_pair(jv, seed, beat, lead)
    primers, sheets = _jobs(jv, 4, np.random.RandomState(0))
    gaps = SampledGaps(monkeypatch)
    tres = ts2b.Stage2BatchGenerator(tm, _port_vocab(jv), batch=4, device='cpu',
                                     **KW).generate(primers, sheets, seed=11)
    jres = JaxGenerator(jm, params, jv, batch=4, **KW).generate(
        primers, sheets, seed=3)
    _check_batched(jres, tres, gaps, (jm, params, tm), jv)
    assert set(want) <= set(tres[1]['status'])
    assert tres[1]['tier_resumes'] == 0


@pytest.mark.parametrize('name', sorted(CASES))
def test_serve_matches_jax_greedy(name, monkeypatch):
    """6 jobs through 4 slots: a refilled slot rebuilds its cache from
    position 0, so each job's stream is its own whatever its slot."""
    seed, beat, lead, _ = CASES[name]
    jv = tiny_vocab2()
    jm, params, tm = _biased_pair(jv, seed, beat, lead)
    primers, sheets = _jobs(jv, 6, np.random.RandomState(1))
    gaps = SampledGaps(monkeypatch)
    tres = ts2b.Stage2BatchGenerator(tm, _port_vocab(jv), batch=4, device='cpu',
                                     **KW).serve(primers, sheets, seed=11)
    jres = JaxGenerator(jm, params, jv, batch=4, **KW).serve(
        primers, sheets, seed=3)
    _check_batched(jres, tres, gaps, (jm, params, tm), jv)
    assert tres[1]['chunks'] >= 2


def test_ladder_matches_single_cache_sampled():
    """temp 1.2, top_p 0.97: the ladder (tiers 16 and 64, then the 256 cache
    with its re-anchors) gives the single-cache run's streams token for
    token, with both migrations made."""
    jv = tiny_vocab2()
    _, _, tm = _biased_pair(jv, 13, -0.5, 0.5)
    pv = _port_vocab(jv)
    primers, sheets = _jobs(jv, 4, np.random.RandomState(2))
    kw = dict(KW, temp=1.2, top_p=0.97)
    want, wstats = ts2b.Stage2BatchGenerator(
        tm, pv, batch=4, device='cpu', **kw).generate(primers, sheets, seed=5)
    got, gstats = ts2b.Stage2BatchGenerator(
        tm, pv, batch=4, device='cpu', gpt2_tiers=(64, 16, 400),
        **kw).generate(primers, sheets, seed=5)
    assert got == want
    for key in ('status', 'rejects', 'reanchors'):
        assert gstats[key] == wstats[key], key
    assert gstats['tier_resumes'] == 2 and wstats['tier_resumes'] == 0
    assert sum(gstats['reanchors']) >= 1


def test_generator_arguments_are_checked():
    jv = tiny_vocab2()
    pv = _port_vocab(jv)
    _, _, tm = gpt2_pair(jv.size)
    with pytest.raises(ValueError, match='gpt2_tiers'):
        ts2b.Stage2BatchGenerator(tm, pv, batch=2, device='cpu',
                                  gpt2_tiers=[250], **KW)
    with pytest.raises(ValueError, match='gpt2_window'):
        ts2b.Stage2BatchGenerator(tm, pv, batch=2, device='cpu',
                                  **dict(KW, gpt2_cache_len=150))
    tm.train()
    with pytest.raises(ValueError, match='eval'):
        ts2b.Stage2BatchGenerator(tm, pv, batch=2, device='cpu', **KW)
    with pytest.raises(ValueError, match='eval'):
        ts2.Stage2Generator(tm, pv, temp=1.0, top_p=0.0, device='cpu')
    # the Performer ignores the ladder, as in JAX
    _, _, _, pm, om = model_pair(jv.size)
    gen = ts2b.Stage2BatchGenerator(pm, pv, batch=2, omegas=om, device='cpu',
                                    gpt2_tiers=[48], **KW)
    assert gen.tiers == []


@pytest.mark.parametrize('backbone', ['performer', 'gpt2'])
def test_host_generator_matches_jax_greedy(backbone, monkeypatch):
    """One song through Stage2Generator on both sides; GPT-2 re-anchors
    (both triggers can fire with the 256-position cache)."""
    jv = tiny_vocab2()
    primers, sheets = _jobs(jv, 1, np.random.RandomState(3), bars=(10, 11))
    kw = dict(temp=1.0, top_p=0.0, max_events=400, **CACHE)
    if backbone == 'gpt2':
        jm, params, tm = _biased_pair(jv, 13, -0.5, 0.5)
        jgen = JaxHostGenerator(jm, params, jv, **kw)
        tgen = ts2.Stage2Generator(tm, _port_vocab(jv), device='cpu', **kw)
    else:
        jm, params, jom, tm, tom = model_pair(jv.size, seed=13, std=0.1)
        jgen = JaxHostGenerator(jm, params, jv, omegas=jom, **kw)
        tgen = ts2.Stage2Generator(tm, _port_vocab(jv), omegas=tom,
                                   device='cpu', **kw)
    gaps = SampledGaps(monkeypatch)
    got, gstats = tgen.generate(primers[0], sheets[0], seed=1)
    want, wstats = jgen.generate(primers[0], sheets[0], seed=4)
    assert got == want
    for key in ('status', 'bars', 'n_events'):
        assert gstats[key] == wstats[key], key
    assert gaps.check(batched=False) > 100
    if backbone == 'gpt2':
        assert gstats['reanchors'] >= 1 and len(got) > 256


def test_reference_exact_matches_jax():
    """The same np.random seed on both sides, window 48: the stream outgrows
    the window, so its tail comes from the full-window re-forward."""
    jv = tiny_vocab2()
    jm, params, tm = gpt2_pair(jv.size, seed=7, std=0.1)
    primer = [jv.event2idx[e] for e in ('Emotion_Q1', 'Key_C', 'Tempo_110')]
    _, sheets = _jobs(jv, 1, np.random.RandomState(4), bars=(8, 9))
    kw = dict(lead_sheet_events=sheets[0], primer=primer, max_events=120,
              temp=1.2, top_p=0.9, window=48)
    np.random.seed(21)
    want, wsteps = jax_reference_exact(jm, params, jv, **kw)
    np.random.seed(21)
    got, gsteps = generate_stage2_reference_exact(tm, _port_vocab(jv), **kw)
    assert got == want and gsteps == wsteps
    assert len(got) > 2 * 48

