"""Sampling and batched stage-2 generation: the port (CPU) against the JAX
package.  At ``top_p=0`` the nucleus keeps only the most probable token,
so both generators are deterministic whatever their random streams, and
their token streams, statuses, bar counts and reject counts must agree
exactly.  A cross-framework near-tie could flip a token silently, so the
test replays each stream through both models' forwards, asserts that their
logits agree within LOGIT_TOL, and that at every sampled step the top-2
logit gap exceeds ten times LOGIT_TOL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.infer.stage2_batch import (
    Stage2BatchGenerator as JaxGenerator)
from emo_disentanger_tpu.ops.sampling import nucleus_sample as jax_nucleus
from emo_disentanger_tpu_torch.core.vocab import Vocab
from emo_disentanger_tpu_torch.infer.stage2_batch import (
    STATUS_DONE_BARS, STATUS_MAX, STATUS_STUCK, Stage2BatchGenerator)
from emo_disentanger_tpu_torch.ops.sampling import (
    nucleus_sample, nucleus_sample_numpy)
from tests_vocab_helper import tiny_vocab2
from torch_port_helpers import model_pair

# f32 logits of the two-layer model agree to ~1e-6 across frameworks
LOGIT_TOL = 2e-5


@pytest.mark.parametrize('top_p', [0.5, 0.9, 0.99])
def test_nucleus_kept_set_matches_numpy(top_p):
    """The support of many draws equals the reference sampler's: the same
    second-crossing nucleus (every kept token has probability >= 1/60 here,
    so 3000 draws miss none)."""
    rng = np.random.RandomState(int(top_p * 100))
    logits = rng.randn(12).astype(np.float32)
    ref = {nucleus_sample_numpy(rng, logits, 1.2, top_p) for _ in range(3000)}
    rows = torch.from_numpy(np.tile(logits, (3000, 1)))
    got = nucleus_sample(rows, 1.2, top_p, torch.Generator().manual_seed(0))
    assert set(got.tolist()) == ref


def test_nucleus_top_p_zero_is_argmax():
    rng = np.random.RandomState(3)
    logits = rng.randn(5, 30).astype(np.float32)
    got = nucleus_sample(torch.from_numpy(logits), 1.1, 0.0,
                         torch.Generator().manual_seed(1))
    assert got.tolist() == logits.argmax(-1).tolist()
    want = jax.vmap(jax_nucleus, in_axes=(0, 0, None, None))(
        jax.random.split(jax.random.PRNGKey(0), 5), jnp.asarray(logits),
        1.1, 0.0)
    assert got.tolist() == np.asarray(want).tolist()


def _port_vocab(jv):
    ev = {e: i for e, i in jv.event2idx.items() if e != 'PAD_None'}
    return Vocab(ev, {i: e for e, i in ev.items()})


def _jobs(vocab, n, rng):
    e = vocab.event2idx
    primers, sheets = [], []
    for j in range(n):
        primers.append([e['Emotion_Q1' if j % 2 else 'Emotion_Q2'],
                        e['Key_C' if j % 2 else 'Key_c'], e['Tempo_110']])
        bars = []
        for _ in range(rng.randint(2, 5)):
            beats = sorted(rng.choice(16, size=2, replace=False))
            bars.append([e['Bar_None'], e[f'Beat_{beats[0]}'], e['Chord_I_M'],
                         e['Note_Octave_5'], e['Note_Degree_I'],
                         e[f'Beat_{beats[1]}'], e['Chord_V_7'],
                         e['Note_Degree_V'], e['Note_Duration_480']])
        sheets.append(bars)
    return primers, sheets


def _walk(stream, primer, bars, lead):
    """(sampled positions, segment ids) of a stream: the primer and its
    Track_LeadSheet (seg 0), then each bar's injected row (seg 0, its
    Track_Full terminator seg 1), then sampled tokens (seg 1, a
    Track_LeadSheet seg 0) until a sampled Track_LeadSheet opens the next
    bar's injection.  When the stream ends while sampling, the position
    after it counts too: the dropped final token (or a stuck job's
    rejected ones) came from the last logits."""
    segs, sampled = [0] * (len(primer) + 1), []
    k, queue = 0, [0] * len(bars[0]) + [1]
    for p in range(len(primer) + 1, len(stream)):
        if queue:
            segs.append(queue.pop(0))
            continue
        sampled.append(p)
        segs.append(0 if stream[p] == lead else 1)
        if stream[p] == lead and k + 1 < len(bars):
            k += 1
            queue = [0] * len(bars[k]) + [1]
    if not queue:
        sampled.append(len(stream))
    return sampled, segs


def _check_gaps(models, vocab, streams, primers, sheets):
    """Replay the streams through both forwards (one causal batch, padded
    at the end): the logits agree within LOGIT_TOL, and the top-2 gap
    exceeds 10 x LOGIT_TOL at every step whose token was sampled (a
    rejected sample was drawn from the same logits as the accepted one
    after it)."""
    jm, params, jom, tm, tom = models
    lead = vocab.event2idx['Track_LeadSheet']
    walks = [_walk(*job, lead) for job in zip(streams, primers, sheets)]
    L = max(len(s) for s in streams)
    tok = np.full((len(streams), L), vocab.pad_id, np.int32)
    seg = np.zeros((len(streams), L), np.int32)
    for b, (stream, (_, segs)) in enumerate(zip(streams, walks)):
        tok[b, :len(stream)] = stream
        seg[b, :len(stream)] = segs[:len(stream)]
    with torch.no_grad():
        logits = tm(torch.from_numpy(tok).long(), tom,
                    torch.from_numpy(seg).long())
    want = jm.apply(params, jnp.asarray(tok), jom, jnp.asarray(seg))
    np.testing.assert_allclose(logits, np.asarray(want), rtol=0, atol=LOGIT_TOL)
    checked = 0
    for b, (sampled, _) in enumerate(walks):
        for p in sampled:
            top2 = logits[b, p - 1].topk(2).values
            assert float(top2[0] - top2[1]) > 10 * LOGIT_TOL, (b, p, top2)
            checked += 1
    return checked


# head biases: PAD and EOS never win (an argmax stuck on a rejected token
# would only spin until the step budget); the beat and Track_LeadSheet
# offsets pick, per weight seed, a mix of final statuses
CASES = {
    'done-and-max': dict(seed=9, beat=-0.5, lead=0.5, want=(STATUS_DONE_BARS, STATUS_MAX)),
    'done-and-stuck': dict(seed=13, beat=-0.3, lead=0.5, want=(STATUS_DONE_BARS, STATUS_STUCK)),
}


def _generators(jv, case):
    pad, eos = jv.pad_id, jv.event2idx['EOS_None']
    beats = [jv.event2idx[f'Beat_{b}'] for b in range(16)]
    lead = jv.event2idx['Track_LeadSheet']

    def bias(b):
        b[pad] = b[eos] = -30.0
        b[beats] += case['beat']
        b[lead] += case['lead']
    models = model_pair(jv.size, seed=case['seed'], std=0.1, bias_fn=bias)
    jm, params, jom, tm, tom = models
    kw = dict(batch=4, temp=1.1, top_p=0.0, max_events=60, max_bar_tokens=16,
              max_bars=8)
    jgen = JaxGenerator(jm, params, jv, omegas=jom, **kw)
    tgen = Stage2BatchGenerator(tm, _port_vocab(jv), omegas=tom,
                                device='cpu', **kw)
    return jgen, tgen, models


def _check(jres, tres, case, models, jv, primers, sheets):
    (js, jstats), (ts, tstats) = jres, tres
    assert ts == js
    for key in ('status', 'bars', 'rejects', 'events'):
        assert tstats[key] == jstats[key], key
    assert set(case['want']) <= set(tstats['status'])
    assert _check_gaps(models, jv, ts, primers, sheets) > 20


@pytest.mark.parametrize('name', sorted(CASES))
def test_generate_matches_jax_greedy(name):
    jv = tiny_vocab2()
    jgen, tgen, models = _generators(jv, CASES[name])
    primers, sheets = _jobs(jv, 4, np.random.RandomState(0))
    _check(jgen.generate(primers, sheets, seed=3),
           tgen.generate(primers, sheets, seed=11),
           CASES[name], models, jv, primers, sheets)


@pytest.mark.parametrize('name', sorted(CASES))
def test_serve_matches_jax_greedy(name):
    """6 jobs through 4 slots: a refill zeroes the slot's state, so each
    job's stream is its own whatever its slot and refill time."""
    jv = tiny_vocab2()
    jgen, tgen, models = _generators(jv, CASES[name])
    primers, sheets = _jobs(jv, 6, np.random.RandomState(1))
    tres = tgen.serve(primers, sheets, seed=11)
    _check(jgen.serve(primers, sheets, seed=3), tres,
           CASES[name], models, jv, primers, sheets)
    assert tres[1]['chunks'] >= 2
