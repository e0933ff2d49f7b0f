"""The port's own spans and counters (``utils/profiling``): nothing without
a profiler; under ``torch.profiler`` the serve loop's step, sampler and
refill ranges and its exact slot counts, and the stage-2 loader's batch
ranges; the same streams, stats and batches with the profiler on and off;
one host read a status poll either way; per-job times in ``serve``'s
stats."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from helpers import write_stage2_corpus

from emo_disentanger_tpu_torch.core.vocab import Vocab
from emo_disentanger_tpu_torch.data.datasets import Stage2Dataset
from emo_disentanger_tpu_torch.infer import stage2_batch as s2b
from emo_disentanger_tpu_torch.models import MusicGPT2, MusicPerformer
from emo_disentanger_tpu_torch.utils import profiling
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

EVENTS = sorted(['Emotion_Q1', 'Emotion_Q2', 'Key_C', 'Key_c', 'Bar_None',
                 'EOS_None', 'Track_LeadSheet', 'Track_Full', 'Tempo_110',
                 'Chord_I_M', 'Chord_V_7', 'Note_Octave_5', 'Note_Degree_I',
                 'Note_Degree_V', 'Note_Duration_480']
                + [f'Beat_{b}' for b in range(16)])
SLOTS, JOBS = 3, 7
KW = dict(batch=SLOTS, temp=1.1, top_p=0.0, max_events=40, max_bar_tokens=16,
          max_bars=8, serve_chunk_steps=16, device='cpu')
TIMES = ('seconds', 'wall_seconds', 'admitted_s', 'finished_s')


@pytest.fixture(autouse=True)
def empty_counts():
    profiling.COUNTS.clear()
    yield
    profiling.COUNTS.clear()


def _vocab():
    return Vocab({e: i for i, e in enumerate(EVENTS)},
                 {i: e for i, e in enumerate(EVENTS)})


def _generator(backbone):
    """A tiny greedy generator whose head never picks PAD or EOS, so songs
    end by their bars, their event budget or a stuck beat."""
    vocab = _vocab()
    torch.manual_seed(5)
    shape = dict(n_token=vocab.size, n_layer=2, n_head=2, d_model=32, d_ff=64,
                 d_embed=32, dropout=0.0, device='cpu')
    if backbone == 'performer':
        model = MusicPerformer(favor_dims=16, **shape)
        extra = dict(omegas=model.draw_omegas(torch.Generator().manual_seed(1)))
    else:
        model = MusicGPT2(**shape)
        extra = dict(gpt2_cache_len=320, gpt2_window=64, reanchor_margin=16)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape) * 0.1)
        bias = model.dec_out_proj.bias
        bias[vocab.pad_id] = bias[vocab.event2idx['EOS_None']] = -30.0
        bias[vocab.event2idx['Track_LeadSheet']] += 0.5
    return s2b.Stage2BatchGenerator(model.eval(), vocab, **KW, **extra)


def _jobs(vocab, n):
    rng = np.random.RandomState(0)
    e = vocab.event2idx
    primers, sheets = [], []
    for j in range(n):
        primers.append([e['Emotion_Q1' if j % 2 else 'Emotion_Q2'],
                        e['Key_C' if j % 2 else 'Key_c'], e['Tempo_110']])
        bars = []
        for _ in range(rng.randint(1, 4)):
            beats = sorted(rng.choice(16, size=2, replace=False))
            bars.append([e['Bar_None'], e[f'Beat_{beats[0]}'], e['Chord_I_M'],
                         e['Note_Octave_5'], e['Note_Degree_I'],
                         e[f'Beat_{beats[1]}'], e['Chord_V_7'],
                         e['Note_Degree_V'], e['Note_Duration_480']])
        sheets.append(bars)
    return primers, sheets


def _ranges(prof, name):
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == name)


def _inside(inner, outer):
    return all(any(a <= x and y <= b for a, b in outer) for x, y in inner)


def test_no_profiler_no_span_and_no_count():
    assert not profiling.recording()
    assert profiling.span('emodis.a') is profiling.span('emodis.b')
    profiling.count('serve.x', 3)
    assert not profiling.COUNTS
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        with profiling.span('emodis.a') as sp:
            assert sp is not profiling.span('emodis.b')
        profiling.count('serve.x', 3)
    assert profiling.COUNTS == {'serve.x': 3}


@pytest.mark.parametrize('backbone', ['performer', 'gpt2'])
def test_counts_and_ranges_of_a_whole_profiled_call(backbone):
    """Every step, sample and refill of a call is a range; the counters
    hold the call's steps and its songs' slot-steps exactly; the per-job
    times follow the chunks."""
    gen = _generator(backbone)
    primers, sheets = _jobs(gen.vocab, JOBS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, stats = gen.serve(primers, sheets, seed=4)
    c = profiling.COUNTS
    assert stats['chunks'] >= 3
    assert c['serve.steps'] == stats['steps'] == len(
        _ranges(prof, 'emodis.serve.step'))
    assert c['serve.slot_steps'] == sum(stats['events']) + sum(stats['rejects'])
    if backbone == 'gpt2':
        # a song's advancing steps run at clocks 0 .. n-1; a rejected step
        # at its clock again
        least = sum(n * (n - 1) // 2 for n in stats['events'])
        assert (c['serve.live_rows'] == least if not any(stats['rejects'])
                else c['serve.live_rows'] > least)
    else:
        assert 'serve.live_rows' not in c
    steps = _ranges(prof, 'emodis.serve.step')
    samples = _ranges(prof, 'emodis.serve.sample')
    assert len(samples) == len(steps) and _inside(samples, steps)
    refills = _ranges(prof, 'emodis.serve.refill')
    assert len(refills) == stats['chunks']
    assert not any(a < y and x < b for a, b in refills for x, y in steps)
    adm, fin = stats['admitted_s'], stats['finished_s']
    assert len(set(adm[:SLOTS])) == 1
    assert all(0 <= a < f <= stats['wall_seconds'] for a, f in zip(adm, fin))
    assert set(adm[SLOTS:]) <= set(fin) and adm[SLOTS:] == sorted(adm[SLOTS:])


@pytest.mark.parametrize('backbone', ['performer', 'gpt2'])
def test_a_schedule_counts_its_active_steps(backbone):
    """Under a profiler schedule stepped once a decode step, the ranges and
    the counts hold the active steps only, and the counts reach ``COUNTS``
    though the profiler stopped before the next poll."""
    gen = _generator(backbone)
    primers, sheets = _jobs(gen.vocab, JOBS)
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=4, warmup=1, active=7, repeat=1))
    real = gen._step

    def step(s, g):
        prof.step()
        real(s, g)
    gen._step = step
    with prof:
        _, stats = gen.serve(primers, sheets, seed=4)
    assert stats['steps'] > 20
    assert len(_ranges(prof, 'emodis.serve.step')) == 7
    assert profiling.COUNTS['serve.steps'] == 7
    assert 0 < profiling.COUNTS['serve.slot_steps'] <= 7 * SLOTS


@pytest.mark.parametrize('backbone', ['performer', 'gpt2'])
@pytest.mark.parametrize('call', ['serve', 'generate'])
def test_streams_and_stats_alike_with_the_profiler_on_and_off(backbone, call):
    gen = _generator(backbone)
    n = JOBS if call == 'serve' else SLOTS
    primers, sheets = _jobs(gen.vocab, n)
    off = getattr(gen, call)(primers, sheets, seed=4)
    with profile(activities=[ProfilerActivity.CPU]):
        on = getattr(gen, call)(primers, sheets, seed=4)
    assert on[0] == off[0]
    drop = lambda st: {k: v for k, v in st.items() if k not in TIMES}
    assert drop(on[1]) == drop(off[1])
    if call == 'generate':
        assert profiling.COUNTS['serve.steps'] == on[1]['steps']


@pytest.mark.parametrize('recording', [False, True])
def test_poll_reads_the_host_once(recording, monkeypatch):
    gen = _generator('gpt2')
    primers, sheets = _jobs(gen.vocab, SLOTS)
    s = gen._init_state(gen._prep_jobs(primers, sheets, None), range(SLOTS))
    g = gen._generator(0)
    reads = []
    for name in ('tolist', 'item', '__bool__', 'cpu', 'numpy'):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda t, *a, _r=real, _n=name, **k:
                            (reads.append(_n), _r(t, *a, **k))[1])
    prof = profile(activities=[ProfilerActivity.CPU])
    if recording:
        prof.start()
    try:
        for _ in range(3):
            gen._step(s, g)
        assert ('counted' in s) == recording
        reads.clear()
        gen._poll(s)
        assert reads == ['tolist']
        assert 'counted' not in s
    finally:
        if recording:
            prof.stop()
    monkeypatch.undo()
    assert profiling.COUNTS['serve.steps'] == (3 if recording else 0)


def test_loader_batches_alike_and_one_range_a_batch(tmp_path):
    events_dir, vocab_path, _ = write_stage2_corpus(str(tmp_path), n_pieces=5)
    make = lambda: Stage2Dataset(events_dir, Vocab.load(vocab_path),
                                 model_dec_seqlen=48, seed=3)
    off = list(make().batches(2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = list(make().batches(2))
    assert len(on) == len(off) == 3
    for a, b in zip(on, off):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(_ranges(prof, 'emodis.data.batch')) == 3
