"""The decode-state layouts of the PyTorch port (CPU) against the JAX
package's (``tests/test_cache_layout.py``, ``tests/test_gpt2_ladder.py:45``):
the stage-1 caches 'khd' [B, K, H, Dh], 'hkd' [B, H, K, Dh] and 'dk'
[B, H, Dh, K], GPT-2's 'khd' and 'dk', and the Performer's FAVOR+ state 'dm'
[.., Dh, M] and 'md' [.., M, Dh].

Every case holds the port in one layout against JAX in the same layout on
numpy-seeded weights, and against the port's default layout.  Step logits
agree within JAX's cross-layout tolerance, rtol = atol = 2e-5 (the
head-major bodies add in another order).  Generators are compared with JAX
greedily (``top_p=0``, primers that hold their key, as
``test_torch_stage1_serve.py`` and ``test_torch_gpt2_serve.py`` do) and
across the port's layouts at sampled settings, where f32 streams must be
equal, as JAX's own test holds them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.infer.stage1 import Stage1Generator as JaxSingle
from emo_disentanger_tpu.infer.stage1_batch import (
    Stage1BatchGenerator as JaxBatch)
from emo_disentanger_tpu.infer.stage2_batch import (
    Stage2BatchGenerator as JaxStage2)
from emo_disentanger_tpu.models import MusicGPT2 as JaxGPT2
from emo_disentanger_tpu.models import MusicPerformer as JaxPerformer
from emo_disentanger_tpu.models.txl import PlainTransformer as JaxTXL
from emo_disentanger_tpu_torch.infer.stage1 import Stage1Generator
from emo_disentanger_tpu_torch.infer.stage1_batch import Stage1BatchGenerator
from emo_disentanger_tpu_torch.infer.stage2_batch import Stage2BatchGenerator
from test_torch_gpt2_serve import CACHE, _biased_pair, _jobs
from test_torch_stage1_serve import (
    CASES, EMOTIONS, KW, PRIMERS, TARGETS, _models, _port_vocab)
from test_torch_txl import txl_pair
from tests_vocab_helper import tiny_vocab2
from torch_port_helpers import model_pair, one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)          # tests/test_cache_layout.py
V = 40
HEAD_MAJOR = ['dk', 'hkd']


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------- stage 1

def _s1_steps(jm, params, tm, layout, toks, t0, K, per_element):
    """(port logits [steps, B, V], JAX logits, port cache, JAX cache) of a
    teacher-forced decode in ``layout``; ``per_element`` takes clocks t0 + i
    [B] through ``decode_step_pe``, else the shared clock i through the
    whole-cache ``decode_step``."""
    B = toks.shape[1]
    jc = jm.apply(params, B, K, layout, method=JaxTXL.init_decode_cache)
    tc = tm.init_decode_cache(B, K, layout)
    got, want = [], []
    for i, tok in enumerate(toks):
        tt = torch.from_numpy(tok).long()
        with torch.no_grad():
            if per_element:
                t = t0 + i
                lg, _ = tm.decode_step_pe(tt, torch.from_numpy(t).long(), tc,
                                          layout)
                jl, jc = jm.apply(params, jnp.asarray(tok), jnp.asarray(t), jc,
                                  layout=layout,
                                  method=JaxTXL.decode_step_pe)
            else:
                lg, _ = tm.decode_step(tt, i, tc, full_attention=True,
                                       layout=layout)
                jl, jc = jm.apply(params, jnp.asarray(tok), jnp.int32(i), jc,
                                  full_attention=True, layout=layout,
                                  method=JaxTXL.decode_step)
        got.append(lg.numpy())
        want.append(np.asarray(jl))
    return np.stack(got), np.stack(want), tc, jc


@pytest.mark.parametrize('clock', ['shared', 'per-element'])
@pytest.mark.parametrize('layout', ['khd', 'dk', 'hkd'])
def test_stage1_decode_layouts_match_jax(layout, clock):
    """Teacher-forced steps: the shared clock (20 steps, B=3) and ragged
    per-element clocks (element b starts at b, 10 steps, B=4) into a
    32-row cache.  Logits against JAX in the same layout and against the
    port's 'khd'; the caches against JAX's at the end."""
    jm, params, tm = txl_pair(V, seed=8)
    per_element = clock == 'per-element'
    B, steps = (4, 10) if per_element else (3, 20)
    toks = np.random.RandomState(3).randint(0, V, (steps, B)).astype(np.int32)
    t0 = np.arange(B, dtype=np.int32)
    got, want, tc, jc = _s1_steps(jm, params, tm, layout, toks, t0, 32,
                                  per_element)
    _close(got, want)
    base = _s1_steps(jm, params, tm, 'khd', toks, t0, 32, per_element)[0]
    _close(got, base)
    for name in ('k', 'v', 'r'):
        assert tuple(tc[name].shape) == jc[name].shape, name
        _close(tc[name], jc[name])


@pytest.mark.parametrize('layout', HEAD_MAJOR)
def test_stage1_head_major_layouts_take_the_whole_cache(layout):
    """The chunked attention reads 'khd' only: a head-major decode refuses
    ``full_attention=False`` and takes the whole-cache attention when
    asked for none, as JAX does (``txl.py:429-434``); the position heads
    are built head-major once, [n_layer, H, Dh, K]."""
    _, _, tm = txl_pair(V, seed=8)
    cache = tm.init_decode_cache(2, 16, layout)
    assert cache['r'].shape == (2, 4, 16, 16) and cache['r'].is_contiguous()
    tok = torch.tensor([1, 2])
    with pytest.raises(ValueError, match="needs layout='khd'"):
        tm.decode_step(tok, 0, cache, full_attention=False, layout=layout)
    with torch.no_grad():
        auto, _ = tm.decode_step(tok, 0, cache, layout=layout)
        full, _ = tm.decode_step(tok, 0, tm.init_decode_cache(2, 16, layout),
                                 full_attention=True, layout=layout)
    assert torch.equal(auto, full)
    with pytest.raises(ValueError, match='unknown cache layout'):
        tm.init_decode_cache(2, 16, 'kdh')


def _same(a, b, keys):
    (sa, ta), (sb, tb) = a, b
    assert sa == sb
    for key in keys:
        assert ta[key] == tb[key], key


@pytest.mark.parametrize('layout', HEAD_MAJOR)
def test_stage1_generate_ladder_layouts(layout):
    """The lockstep ``generate`` through the ladder: greedy against JAX's
    generator in the same layout ([56, 104]), sampled (1.2 / 0.97) against
    the port's 'khd' ([40, 104]), the moves to the second tier made."""
    case = CASES['bars-done-overflow']
    jv = tiny_vocab2()
    jm, params, tm = _models(jv, case)
    pv = _port_vocab(jv)
    args = dict(seed=11, primers=PRIMERS, target_bars=TARGETS)
    keys = ('status', 'bars', 'events', 'rejects', 'resumed')
    kw = dict(KW, batch=4, top_p=0.0, fast_slack=16)
    got = Stage1BatchGenerator(tm, pv, device='cpu', cache_layout=layout,
                               **kw).generate(EMOTIONS, **args)
    want = JaxBatch(jm, params, jv, cache_layout=layout, **kw).generate(
        EMOTIONS, **dict(args, seed=3))
    _same(got, want, keys)
    assert got[1]['resumed'] >= 1
    kw.update(top_p=0.97, fast_slack=0)          # the ladder [40, 104]
    runs = [Stage1BatchGenerator(tm, pv, device='cpu', cache_layout=lay,
                                 **kw).generate(EMOTIONS, **args)
            for lay in ('khd', layout)]
    _same(runs[0], runs[1], keys + ('iters',))
    assert runs[1][1]['resumed'] >= 1


@pytest.mark.parametrize('layout', HEAD_MAJOR)
def test_stage1_serve_layouts(layout, monkeypatch):
    """6 jobs through 4 slots with per-slot clocks and refills: greedy
    against JAX in the same layout; sampled against the port's 'khd'.  The
    layout comes from ``EMODIS_S1_CACHE_LAYOUT`` on both sides."""
    case = CASES['rejects-overflow']
    jv = tiny_vocab2()
    jm, params, tm = _models(jv, case)
    pv = _port_vocab(jv)
    emotions, primers = EMOTIONS + EMOTIONS[:2], PRIMERS + PRIMERS[2:]
    args = dict(seed=11, primers=primers, target_bars=TARGETS + [5, 2],
                chunk_steps=16)
    keys = ('status', 'bars', 'events', 'rejects')
    kw = dict(KW, batch=4, top_p=0.0)
    monkeypatch.setenv('EMODIS_S1_CACHE_LAYOUT', layout)
    gen = Stage1BatchGenerator(tm, pv, device='cpu', **kw)
    assert gen.cache_layout == layout
    got = gen.serve(emotions, **args)
    want = JaxBatch(jm, params, jv, **kw).serve(emotions, **dict(args, seed=3))
    _same(got, want, keys)
    assert got[1]['chunks'] >= 2
    monkeypatch.delenv('EMODIS_S1_CACHE_LAYOUT')
    kw['top_p'] = 0.97
    runs = [Stage1BatchGenerator(tm, pv, device='cpu', cache_layout=lay,
                                 **kw).serve(emotions, **args)
            for lay in ('khd', layout)]
    _same(runs[0], runs[1], keys + ('steps', 'chunks'))


@pytest.mark.parametrize('layout', HEAD_MAJOR)
def test_stage1_single_song_layouts(layout):
    """``Stage1Generator``: the chunked attention in 'khd', the whole cache
    in ``layout``; greedy against JAX in the same layout, sampled against
    the port's 'khd'."""
    jv = tiny_vocab2()
    jm, params, tm = _models(jv, CASES['rejects-overflow'])
    pv = _port_vocab(jv)
    jgen = JaxSingle(jm, params, jv, top_p=0.0, cache_layout=layout, **KW)
    tgen = Stage1Generator(tm, pv, top_p=0.0, device='cpu',
                           cache_layout=layout, **KW)
    keys = ('status', 'bars', 'n_events')
    for primer, emotion, target in zip(PRIMERS[1:3], EMOTIONS[1:3], (4, 8)):
        got = tgen.generate(emotion, 1, primer_events=primer,
                            target_bars=target)
        want = jgen.generate(emotion, 0, primer_events=primer,
                             target_bars=target)
        _same(got, want, keys)
    sampled = [Stage1Generator(tm, pv, top_p=0.97, device='cpu',
                               cache_layout=lay, **KW).generate(
                                   'Q1', 9, target_bars=6)
               for lay in ('khd', layout)]
    _same(sampled[0], sampled[1], keys)
    assert sampled[0][1]['n_events'] > 10


def test_generator_layouts_are_checked():
    jv = tiny_vocab2()
    pv = _port_vocab(jv)
    _, _, tm = txl_pair(jv.size)
    with pytest.raises(ValueError, match='cache_layout'):
        Stage1BatchGenerator(tm, pv, batch=2, device='cpu', cache_layout='kdh')
    g2 = _biased_pair(jv, 13, -0.5, 0.5)[2]
    with pytest.raises(ValueError, match="'khd' or 'dk'"):
        Stage2BatchGenerator(g2, pv, batch=2, device='cpu', cache_layout='hkd',
                             **CACHE)
    _, _, _, pm, om = model_pair(jv.size)
    with pytest.raises(ValueError, match="'dm' or 'md'"):
        Stage2BatchGenerator(pm, pv, batch=2, omegas=om, device='cpu',
                             state_layout='mm')


# ---------------------------------------------------------------- GPT-2

@pytest.mark.parametrize('clock', ['shared', 'per-element'])
def test_gpt2_decode_layouts_match_jax(clock):
    """16 steps into a 32-row cache, the shared clock (``decode_step``) or
    per-element clocks starting at b (``decode_step_batchpos``): 'dk'
    against JAX's 'dk' and the port's 'khd'; the caches against JAX's."""
    jv = tiny_vocab2()
    jm, params, tm = _biased_pair(jv, 2, 0.0, 0.0)
    B, K, steps = 3, 32, 16
    toks = np.random.RandomState(2).randint(0, jv.size - 1, (steps, B))
    segs = np.zeros(B, np.int32)
    out = {}
    for layout in ('khd', 'dk'):
        jc = jm.apply(params, B, K, layout, method=JaxGPT2.init_decode_cache)
        tc = tm.init_decode_cache(B, K, layout)
        t = np.zeros(B, np.int32) if clock == 'shared' else np.arange(B, dtype=np.int32)
        got, want = [], []
        for i in range(steps):
            tok = toks[i].astype(np.int32)
            with torch.no_grad():
                if clock == 'shared':
                    lg, _ = tm.decode_step(torch.from_numpy(tok).long(),
                                           torch.from_numpy(segs).long(), i, tc,
                                           layout)
                    jl, jc = jm.apply(params, jnp.asarray(tok), jnp.asarray(segs),
                                      jnp.int32(i), jc, layout=layout,
                                      method=JaxGPT2.decode_step)
                else:
                    lg, _ = tm.decode_step_batchpos(
                        torch.from_numpy(tok).long(), torch.from_numpy(segs).long(),
                        torch.from_numpy(t + i).long(), tc, layout)
                    jl, jc = jm.apply(params, jnp.asarray(tok), jnp.asarray(segs),
                                      jnp.asarray(t + i), jc, layout=layout,
                                      method=JaxGPT2.decode_step_batchpos)
            got.append(lg.numpy())
            want.append(np.asarray(jl))
        _close(np.stack(got), np.stack(want))
        for name in ('k', 'v'):
            assert tuple(tc[name].shape) == jc[name].shape
            _close(tc[name], jc[name])
        out[layout] = np.stack(got)
    _close(out['dk'], out['khd'])


GPT2_KW = dict(temp=1.1, top_p=0.0, max_events=300, max_bar_tokens=32,
               max_bars=12, **CACHE)


@pytest.mark.parametrize('method', ['generate', 'serve'])
def test_gpt2_streams_dk_match_jax_and_khd(method, monkeypatch):
    """Streams through the in-loop re-anchor (a 256-row cache): 'dk' greedy
    against JAX's 'dk' (chosen by ``EMODIS_S2_CACHE_LAYOUT`` on both
    sides), and sampled (1.2 / 0.97) against the port's 'khd'."""
    jv = tiny_vocab2()
    jm, params, tm = _biased_pair(jv, 13, -0.5, 0.5)
    pv = _port_vocab(jv)
    primers, sheets = _jobs(jv, 4 if method == 'generate' else 6,
                            np.random.RandomState(0))
    keys = ('status', 'bars', 'rejects', 'events', 'reanchors')
    monkeypatch.setenv('EMODIS_S2_CACHE_LAYOUT', 'dk')
    gen = Stage2BatchGenerator(tm, pv, batch=4, device='cpu', **GPT2_KW)
    assert gen.cache_layout == 'dk'
    got = getattr(gen, method)(primers, sheets, seed=11)
    want = getattr(JaxStage2(jm, params, jv, batch=4, **GPT2_KW), method)(
        primers, sheets, seed=3)
    _same(got, want, keys)
    assert sum(got[1]['reanchors']) >= 1
    monkeypatch.delenv('EMODIS_S2_CACHE_LAYOUT')
    kw = dict(GPT2_KW, temp=1.2, top_p=0.97)
    runs = [getattr(Stage2BatchGenerator(tm, pv, batch=4, device='cpu',
                                         cache_layout=lay, **kw), method)(
                                             primers, sheets, seed=5)
            for lay in ('khd', 'dk')]
    _same(runs[0], runs[1], keys + ('steps',))
    assert sum(runs[1][1]['reanchors']) >= 1


def test_gpt2_ladder_dk():
    """The ladder in 'dk' (tiers 16 and 64 padded along the last axis, then
    the 256 cache with its re-anchors): greedy against JAX's 'dk' ladder;
    sampled, it equals the port's 'dk' single-cache run and its 'khd'
    ladder, with both moves made (``tests/test_gpt2_ladder.py:45``)."""
    jv = tiny_vocab2()
    jm, params, tm = _biased_pair(jv, 13, -0.5, 0.5)
    pv = _port_vocab(jv)
    primers, sheets = _jobs(jv, 4, np.random.RandomState(2))
    keys = ('status', 'rejects', 'reanchors', 'tier_resumes')
    tiers = dict(gpt2_tiers=(16, 64))
    got = Stage2BatchGenerator(tm, pv, batch=4, device='cpu', cache_layout='dk',
                               **tiers, **GPT2_KW).generate(primers, sheets,
                                                            seed=11)
    want = JaxStage2(jm, params, jv, batch=4, cache_layout='dk', **tiers,
                     **GPT2_KW).generate(primers, sheets, seed=3)
    _same(got, want, keys)
    assert got[1]['tier_resumes'] == 2
    kw = dict(GPT2_KW, temp=1.2, top_p=0.97)
    run = lambda lay, t: Stage2BatchGenerator(  # noqa: E731
        tm, pv, batch=4, device='cpu', cache_layout=lay, **t, **kw).generate(
            primers, sheets, seed=5)
    ladder = run('dk', tiers)
    assert ladder[1]['tier_resumes'] == 2 and sum(ladder[1]['reanchors']) >= 1
    _same(ladder, run('khd', tiers), keys)
    _same(ladder, run('dk', {}), keys[:3])


# ------------------------------------------------------------- Performer

def test_performer_state_layouts_match_jax():
    """12 masked per-element steps (element 1 frozen on odd steps): 'md'
    and 'dm' against JAX's in the same layout, each other, and the states
    against JAX's."""
    jv_size = 30
    jm, params, jom, tm, tom = model_pair(jv_size, seed=9)
    B, steps = 3, 12
    rng = np.random.RandomState(2)
    toks = rng.randint(0, jv_size - 1, (steps, B)).astype(np.int32)
    segs = np.zeros(B, np.int32)
    masks = np.asarray([[True, i % 2 == 0, True] for i in range(steps)])
    out = {}
    for layout in ('md', 'dm'):
        jstate = jm.apply(params, B, layout, method=JaxPerformer.init_decode_state)
        tstate = tm.init_decode_state(B, layout)
        t = np.arange(B, dtype=np.int32)
        got, want = [], []
        for i in range(steps):
            jl, jstate = jm.apply(params, jnp.asarray(toks[i]), jnp.asarray(segs),
                                  jnp.asarray(t), jom, jstate,
                                  update_mask=jnp.asarray(masks[i]),
                                  state_layout=layout,
                                  method=JaxPerformer.decode_step_batchpos)
            with torch.no_grad():
                lg, _ = tm.decode_step_batchpos(
                    torch.from_numpy(toks[i]).long(), torch.from_numpy(segs).long(),
                    torch.from_numpy(t).long(), tom, tstate,
                    update_mask=torch.from_numpy(masks[i]), state_layout=layout)
            t = t + masks[i]
            got.append(lg.numpy())
            want.append(np.asarray(jl))
        _close(np.stack(got), np.stack(want))
        for name in ('S', 'z'):
            assert tuple(tstate[name].shape) == jstate[name].shape
            _close(tstate[name], jstate[name])
        out[layout] = (np.stack(got), tstate['S'])
    _close(out['md'][0], out['dm'][0])
    _close(out['md'][1].transpose(-1, -2), out['dm'][1])


@pytest.mark.parametrize('method', ['generate', 'serve'])
def test_performer_streams_across_state_layouts(method, monkeypatch):
    """The Performer's batched streams in 'md' (``EMODIS_PERF_STATE_LAYOUT``
    on both sides): greedy against JAX's 'md', and sampled (1.1 / 0.99)
    equal to the port's 'dm'."""
    jv = tiny_vocab2()
    jm, params, jom, tm, tom = model_pair(jv.size, seed=13, std=0.1)
    pv = _port_vocab(jv)
    primers, sheets = _jobs(jv, 4 if method == 'generate' else 6,
                            np.random.RandomState(5), bars=(2, 4))
    keys = ('status', 'bars', 'rejects', 'events')
    kw = dict(temp=1.1, top_p=0.0, max_events=150, max_bar_tokens=32)
    monkeypatch.setenv('EMODIS_PERF_STATE_LAYOUT', 'md')
    gen = Stage2BatchGenerator(tm, pv, batch=4, omegas=tom, device='cpu', **kw)
    assert gen.state_layout == 'md'
    got = getattr(gen, method)(primers, sheets, seed=11)
    jgen = JaxStage2(jm, params, jv, batch=4, omegas=jom, **kw)
    assert jgen._state_layout == 'md'
    want = getattr(jgen, method)(primers, sheets, seed=3)
    _same(got, want, keys)
    monkeypatch.delenv('EMODIS_PERF_STATE_LAYOUT')
    kw['top_p'] = 0.99
    runs = [getattr(Stage2BatchGenerator(tm, pv, batch=4, omegas=tom,
                                         device='cpu', state_layout=lay, **kw),
                    method)(primers, sheets, seed=5)
            for lay in ('dm', 'md')]
    _same(runs[0], runs[1], keys + ('steps',))
    assert max(runs[0][1]['events']) > 20
