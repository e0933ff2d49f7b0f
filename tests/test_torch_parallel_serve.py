"""Batch-sharded serving of the port on the CPU, with two gloo ranks standing
in for devices (``torch_parallel_ranks``): the Performer's, GPT-2's and
stage 1's ``generate`` and ``serve`` over a dp=2 mesh.

* Under sampling, the streams, statuses, bar counts and reject counts equal
  the port's one-process run bit for bit (JAX's contract,
  ``tests/test_multichip_serving.py``): every step draws ``torch.rand(B)``
  on every rank, and each rank samples its rows by the inverse CDF.  The
  GPT-2 runs re-anchor their windows and walk a cache ladder, stage 1 walks
  its ladder and samples the key step.
* At ``top_p=0`` the dp runs also equal JAX's run over its 8-device mesh,
  and the one-process run's sampled rows keep a top-2 logit gap above ten
  times the cross-framework logit tolerance, as the one-device tests
  (``test_torch_serve.py``, ``test_torch_gpt2_serve.py``,
  ``test_torch_stage1_serve.py``) require.
"""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from emo_disentanger_tpu.infer.stage1_batch import (
    Stage1BatchGenerator as JaxStage1)
from emo_disentanger_tpu.infer.stage2_batch import (
    Stage2BatchGenerator as JaxStage2)
from emo_disentanger_tpu.parallel.mesh import make_mesh as jax_mesh
from emo_disentanger_tpu_torch.infer import (
    Stage1BatchGenerator, Stage2BatchGenerator)
from test_torch_gpt2_serve import CACHE, SampledGaps, _biased_pair
from test_torch_gpt2_serve import _jobs as gpt2_jobs
from test_torch_serve import _check_gaps, _generators, _jobs
from test_torch_stage1_serve import (
    EMOTIONS, PRIMERS, TARGETS, _models, _port_vocab, _Recorder)
from test_torch_stage1_serve import CASES as S1_CASES
from test_torch_serve import CASES as S2_CASES
from test_torch_txl import TXL_SMALL
from tests_vocab_helper import tiny_vocab2

LOGIT_TOL = 2e-5
B = 8
P_KW = dict(batch=B, temp=1.1, max_events=60, max_bar_tokens=16, max_bars=8,
            serve_chunk_steps=24)
G_KW = dict(batch=B, temp=1.1, max_events=300, max_bar_tokens=32,
            max_bars=12, **CACHE)
S_KW = dict(batch=B, temp=1.2, max_events=40, max_bars=8, reject_slack=64)


def _port(kind, model, vocab, kw):
    if kind == 'stage1':
        return Stage1BatchGenerator(model, vocab, device='cpu', **kw)
    return Stage2BatchGenerator(model, vocab, device='cpu', **kw)


def _strip(res):
    streams, stats = res
    return streams, {k: v for k, v in stats.items()
                     if 'seconds' not in k and not k.endswith('_s')}


LEG_NAMES = [f'{kind}-{method}-{mode}' for mode in ('sampled', 'greedy')
             for kind in ('performer', 'gpt2', 'stage1')
             for method in ('generate', 'serve')]


@pytest.fixture(scope='module')
def legs():
    """{name: (kind, port model, JAX model and params, generator kwargs,
    method, job arguments, greedy)}."""
    torch.set_num_threads(1)
    jv = tiny_vocab2()
    vocab = _port_vocab(jv)
    _, _, pmodels = _generators(jv, S2_CASES['done-and-max'])
    jm, jp, jom, tm, tom = pmodels
    primers, sheets = _jobs(jv, 12, np.random.RandomState(1))
    gm, gp, gtm = _biased_pair(jv, 13, -0.5, 0.5)
    gprimers, gsheets = gpt2_jobs(jv, 12, np.random.RandomState(0))
    sm, sp, stm = _models(jv, S1_CASES['rejects-overflow'])
    legs = []
    for greedy in (False, True):
        pkw = dict(P_KW, omegas=tom, top_p=0.0 if greedy else 0.99)
        gkw = dict(G_KW, top_p=0.0 if greedy else 0.97)
        if not greedy:
            gkw['gpt2_tiers'] = [128]
        skw = dict(S_KW, top_p=0.0 if greedy else 0.97)
        s_gen = ((EMOTIONS * 2,), dict(seed=11, primers=PRIMERS * 2,
                                       target_bars=TARGETS * 2)) if greedy \
            else ((['Q1', 'Q2'] * 4,), dict(seed=5, target_bars=6))
        legs += [
            ('performer', tm, (jm, jp, jom), pkw, 'generate',
             ((primers[:B], sheets[:B]), dict(seed=3)), greedy),
            ('performer', tm, (jm, jp, jom), pkw, 'serve',
             ((primers, sheets), dict(seed=7)), greedy),
            ('gpt2', gtm, (gm, gp), gkw, 'generate',
             ((gprimers[:B], gsheets[:B]), dict(seed=5)), greedy),
            ('gpt2', gtm, (gm, gp), gkw, 'serve',
             ((gprimers, gsheets), dict(seed=9)), greedy),
            ('stage1', stm, (sm, sp), dict(skw, fast_slack=16), 'generate',
             s_gen, greedy),
            ('stage1', stm, (sm, sp), skw, 'serve',
             ((EMOTIONS * 3,), dict(seed=9, primers=PRIMERS * 3,
                                    target_bars=TARGETS * 3,
                                    chunk_steps=16)), greedy)]
    return jv, vocab, dict(zip(LEG_NAMES, legs))


@pytest.fixture(scope='module')
def dp_results(legs, tmp_path_factory):
    """Every leg over a dp=2 mesh, in one spawn of two gloo ranks; both
    ranks return the global streams and stats."""
    _, vocab, legs = legs
    cases = []
    for kind, model, _, kw, method, args, _ in legs.values():
        shape = (dict(TXL_SMALL, dropout=0.0, mem_len=0) if kind == 'stage1'
                 else None)
        cases.append((kind, shape, model.state_dict(), vocab, kw, method,
                      args))
    ranks = R.spawn('leg_serve', 2, tmp_path_factory.mktemp('serve'), cases)
    assert ranks[0] == ranks[1]
    return dict(zip(legs, ranks[0]))


@pytest.mark.parametrize('name', LEG_NAMES)
def test_dp_streams_equal_one_process_and_jax_mesh(name, legs, dp_results,
                                                   monkeypatch):
    jv, vocab, legs = legs
    kind, model, jax_pair, kw, method, args, greedy = legs[name]
    got = dp_results[name]
    gen = _port(kind, model, vocab, kw)
    if greedy and kind == 'gpt2':
        gaps = SampledGaps(monkeypatch)
    elif greedy and kind == 'stage1':
        gaps = _Recorder(monkeypatch, gen)
    want = _strip(getattr(gen, method)(*args[0], **args[1]))
    assert got == want
    if method == 'serve':
        assert want[1]['chunks'] >= 2
    if kind == 'gpt2':
        assert sum(want[1]['reanchors']) >= 1
        if method == 'generate' and not greedy:
            assert want[1]['tier_resumes'] >= 1
    if not greedy:
        return
    jkw = {k: v for k, v in kw.items() if k != 'omegas'}
    if kind == 'stage1':
        jgen = JaxStage1(*jax_pair, jv, mesh=jax_mesh(8), **jkw)
    else:
        if kind == 'performer':
            jkw['omegas'] = jax_pair[2]
        jgen = JaxStage2(*jax_pair[:2], jv, mesh=jax_mesh(8), **jkw)
    jstreams, jstats = getattr(jgen, method)(*args[0], **args[1])
    assert got[0] == jstreams
    for key in ('status', 'bars', 'rejects'):
        assert got[1][key] == jstats[key], key
    if kind == 'performer':
        primers, sheets = args[0]
        assert _check_gaps(model_tuple(jax_pair, model, kw), jv, got[0],
                           primers, sheets) > 20
    elif kind == 'gpt2':
        assert gaps.check(batched=True) > 500
    else:
        assert gaps.min_gap() > 10 * LOGIT_TOL


def model_tuple(jax_pair, model, kw):
    jm, jp, jom = jax_pair
    return jm, jp, jom, model, kw['omegas']
