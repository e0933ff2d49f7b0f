"""Stage 1's spans and counters (``utils/profiling``): under
``torch.profiler`` the song loop's step and sampler ranges, ``serve``'s
refill ranges and the Transformer-XL layers' ``emodis.txl.attn`` ranges,
with exact slot counts; none of them, and no ``record_function``, without
a profiler; the same songs and stats with the profiler on and off; per-job
times in ``serve``'s stats."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from emo_disentanger_tpu_torch.core.vocab import Vocab
from emo_disentanger_tpu_torch.infer.stage1 import Stage1Generator
from emo_disentanger_tpu_torch.infer.stage1_batch import Stage1BatchGenerator
from emo_disentanger_tpu_torch.models.txl import PlainTransformer
from emo_disentanger_tpu_torch.utils import profiling
from torch_port_helpers import one_torch_thread  # noqa: F401

EVENTS = sorted(['Emotion_Positive', 'Emotion_Negative', 'Key_C', 'Key_a',
                 'Bar_None', 'EOS_None', 'Chord_I_M', 'Chord_V_7',
                 'Note_Octave_5', 'Note_Degree_I', 'Note_Degree_V',
                 'Note_Duration_480'] + [f'Beat_{b}' for b in range(16)])
SLOTS, N_LAYER = 3, 2
TIMES = ('seconds', 'wall_seconds', 'admitted_s', 'finished_s')
PRIMERS = [['Emotion_Positive', 'Key_C'], ['Emotion_Negative', 'Key_a'],
           ['Emotion_Positive', 'Key_C', 'Bar_None', 'Beat_4']] * 2 + [
           ['Emotion_Negative', 'Key_a']]
BARS = [2, 6, 3, 2, 5, 2, 4]


@pytest.fixture(autouse=True)
def empty_counts():
    profiling.COUNTS.clear()
    yield
    profiling.COUNTS.clear()


def _generator(cls=Stage1BatchGenerator, **kw):
    """A tiny greedy generator whose head never picks PAD or EOS and often
    Bar_None, so that songs end by their bars at different steps (some
    draws break the beat rule and are rejected)."""
    ev = {e: i for i, e in enumerate(EVENTS)}
    vocab = Vocab(ev, {i: e for e, i in ev.items()})
    model = PlainTransformer(vocab.size, d_embed=32, n_layer=N_LAYER, n_head=2,
                             d_model=32, d_ff=64, dropout=0.0,
                             pad_id=vocab.pad_id, device='cpu',
                             generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(10.0)
        bias = model.dec_out_proj.bias
        bias[vocab.pad_id] = bias[ev['EOS_None']] = -30.0
        bias[ev['Bar_None']] = 1.5
    return cls(model.eval(), vocab, temp=1.2, top_p=0.0, max_events=40,
               reject_slack=8, device='cpu', **kw)


def _serve(gen):
    return gen.serve([p[0].split('_')[1] for p in PRIMERS], seed=4,
                     target_bars=BARS, primers=PRIMERS, chunk_steps=16)


def _ranges(prof, name):
    """The host ranges named ``name``, from the profiler's raw events
    (building its operator tree takes several times as long)."""
    return sorted((e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() == name)


def _inside(inner, outer):
    """Each range of ``inner`` inside some range of ``outer`` (both
    sorted, ``outer`` disjoint)."""
    i = 0
    for x, y in inner:
        while i < len(outer) and outer[i][1] < y:
            i += 1
        if i == len(outer) or not outer[i][0] <= x:
            return False
    return True


def test_counts_and_ranges_of_a_whole_profiled_serve():
    """Every step, sample, refill and layer's cache work is a range; the
    counters hold the call's steps, its songs' slot-steps and their clocks
    exactly (a song's k steps run at clocks 0 .. k - 1); the per-job times
    follow the chunks."""
    gen = _generator(batch=SLOTS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, stats = _serve(gen)
    c = profiling.COUNTS
    steps = [n - 1 + r for n, r in zip(stats['events'], stats['rejects'])]
    assert stats['chunks'] >= 3 and sum(stats['rejects']) > 0
    assert c['serve.steps'] == stats['steps'] == len(
        _ranges(prof, 'emodis.serve.step'))
    assert c['serve.slot_steps'] == sum(steps)
    assert c['serve.live_rows'] == sum(k * (k - 1) // 2 for k in steps)
    step_r = _ranges(prof, 'emodis.serve.step')
    samples = _ranges(prof, 'emodis.serve.sample')
    attn = _ranges(prof, 'emodis.txl.attn')
    assert len(samples) == len(step_r) and _inside(samples, step_r)
    assert len(attn) == N_LAYER * len(step_r) and _inside(attn, step_r)
    refills = _ranges(prof, 'emodis.serve.refill')
    assert len(refills) == stats['chunks']
    assert not any(a < y and x < b for a, b in refills for x, y in step_r)
    adm, fin = stats['admitted_s'], stats['finished_s']
    assert len(set(adm[:SLOTS])) == 1
    assert all(0 <= a < f <= stats['wall_seconds'] for a, f in zip(adm, fin))
    assert set(adm[SLOTS:]) <= set(fin) and adm[SLOTS:] == sorted(adm[SLOTS:])


@pytest.mark.parametrize('call', ['generate', 'single'])
def test_lockstep_steps_are_counted_and_their_attention_marked(call):
    """The shared-clock loop (``generate``'s whole-cache steps,
    ``Stage1Generator``'s chunked ones): every loop step counted, whatever
    stops it; each layer's cache work a range."""
    if call == 'generate':
        gen = _generator(batch=SLOTS)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, stats = gen.generate(['Positive', 'Negative', 'Positive'],
                                    seed=4, target_bars=3,
                                    primers=PRIMERS[:SLOTS])
        steps = stats['iters']
    else:
        gen = _generator(Stage1Generator)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, stats = gen.generate('Positive', seed=4, target_bars=3,
                                    primer_events=PRIMERS[0])
        steps = len(_ranges(prof, 'emodis.serve.step'))
        assert steps > 0
    c = profiling.COUNTS
    assert c['serve.steps'] == steps == len(_ranges(prof, 'emodis.serve.step'))
    assert 0 < c['serve.slot_steps'] <= steps * (SLOTS if call == 'generate' else 1)
    # the single generator's prefill steps run outside the loop, unmarked
    assert len(_ranges(prof, 'emodis.txl.attn')) >= N_LAYER * steps


def test_a_schedule_counts_its_active_steps():
    """Under a profiler schedule stepped once a decode step, the ranges and
    the counts hold the active steps only, and the counts reach ``COUNTS``
    though the profiler stopped before the next poll."""
    gen = _generator(batch=SLOTS)
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=4, warmup=1, active=7, repeat=1))
    real = gen._step

    def step(s, g, **kw):
        prof.step()
        real(s, g, **kw)
    gen._step = step
    with prof:
        _, stats = _serve(gen)
    assert stats['steps'] > 20
    assert len(_ranges(prof, 'emodis.serve.step')) == 7
    assert len(_ranges(prof, 'emodis.txl.attn')) == 7 * N_LAYER
    assert profiling.COUNTS['serve.steps'] == 7
    assert 0 < profiling.COUNTS['serve.slot_steps'] <= 7 * SLOTS


def test_no_profiler_no_range_and_the_same_songs(monkeypatch):
    gen = _generator(batch=SLOTS)
    made = []
    real = torch.profiler.record_function

    def counted(*a, **kw):
        made.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(torch.profiler, 'record_function', counted)
    off = _serve(gen)
    assert made == [] and not profiling.COUNTS
    with profile(activities=[ProfilerActivity.CPU]):
        on = _serve(gen)
    assert made
    assert on[0] == off[0]
    assert ({k: v for k, v in on[1].items() if k not in TIMES}
            == {k: v for k, v in off[1].items() if k not in TIMES})
