"""The stage-1 cell ``txl.serve`` end to end at a tiny size on the CPU: a
sound run passes the check with its metrics, each planted fault and the
float8 control do not, the grammar leaves no rejected step, and the two
readers of the cell find nothing where the program's span or counts are
absent; on a card, the cell at its size."""

import copy
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import calibrate, common, run, traffic_txl, work, work_txl
from portbench.trace import Reading

torch.set_num_threads(2)
CELL = 'txl.serve'
# limits at this size, between the readings of the program (bf16 on the
# CPU) and of its control (float8 operands), five seeds each: program at
# most 0.0102, control at least 0.228; the frozen cache at least 1.02
TINY_LIMITS = {'gap': 0.08, 'unfinished': 0, 'rejected': 0}


class _Event:
    """A raw profiler event as ``Reading`` reads it (times in ns)."""

    def __init__(self, a, b, name, kind, cid=0, link=0):
        from torch.autograd import DeviceType
        self.a, self.b, self._name = a, b, name
        self.cid, self.link = cid, link
        self.dev = (DeviceType.CPU if kind in ('cpu_op', 'user_annotation')
                    else DeviceType.CUDA)

    def name(self): return self._name
    def start_ns(self): return self.a
    def end_ns(self): return self.b
    def device_type(self): return self.dev
    def correlation_id(self): return self.cid
    def linked_correlation_id(self): return self.link


@pytest.fixture
def counts():
    from emo_disentanger_tpu_torch.utils.profiling import COUNTS
    COUNTS.clear()
    yield COUNTS
    COUNTS.clear()


def tiny():
    """The cell with every width and count cut (d_model 256, the least
    that holds the 216 tokens' orthonormal embeddings) and the head
    grammar set for two layers of that width."""
    cell = copy.deepcopy(common.workload(CELL))
    cfg = copy.deepcopy(common.config(cell['config']))
    cfg.update(n_layer=2, n_head=4, d_model=256, d_ff=512, d_embed=256)
    cfg['head_grammar'].update(emb_norm=64.0, value_out_gain=4.0)
    cell['limits'] = dict(TINY_LIMITS)
    cell['traffic'].update(slots=8, queue=20, max_events=80, reject_slack=16,
                           bars=[4, 12])
    cell['trace'] = {'skip': 40, 'steps': 8}
    return cell, cfg


def _run(trace=False, fault=None, seed=2 ** 32 + 12345):
    c, cfg = tiny()
    return run.run_cell(CELL, seed, 0.5, trace, 'cpu', cell=c, cfg=cfg,
                        fault=fault)


def test_cell_runs_correct_with_its_metrics():
    correct, attempted, failed, metrics, _, compared, _ = _run()
    assert correct and attempted > 0 and failed == 0, compared
    assert set(compared) == {'gap', 'unfinished', 'rejected'}
    want = {m['name']: m['unit'] for m in
            common.cell_metrics(common.benchmark(), CELL, 'end_to_end')}
    assert {k: u for k, (_, u) in metrics.items()} == want
    assert all(v > 0 for v, _ in metrics.values())


@pytest.mark.parametrize('fault', ['token', 'frozen'])
def test_fault_comes_out_not_correct(fault):
    correct, *_, compared, _ = _run(fault=fault)
    assert not correct, compared


@pytest.mark.parametrize('seed', [78, 2 ** 33 + 1])
def test_control_is_not_correct(seed):
    c, cfg = tiny()
    got = calibrate.reading(CELL, 'control', seed, 'cpu', cell=c, cfg=cfg)
    assert got['gap'] > c['limits']['gap']


def test_grammar_leaves_no_rejected_step():
    """Every song follows the grammar from its primer's key, to the length
    its target bars set, and no draw was rejected."""
    c, cfg = tiny()
    drv = common.driver('txl_serve').Driver(c, cfg, 5, 'cpu')
    drv.run_window(0.0)
    assert drv.attempted == c['traffic']['queue']
    assert drv.failed == 0 and drv.rejected == 0
    _, w2e = traffic_txl.dictionary()
    rng = np.random.RandomState(drv.s[2])
    _, _, bars = traffic_txl.jobs(c['traffic']['queue'], *c['traffic']['bars'],
                                  rng, True)
    for song, b in zip(drv.songs, bars):
        events = [w2e[i] for i in song['stream']]
        # the stream drops its last token, the closing Bar_None
        assert len(events) == song['primer_len'] + traffic_txl.events_after_primer(b) - 1
        for a, nxt in zip(events[song['primer_len'] - 1:], events[song['primer_len']:]):
            assert nxt in traffic_txl.LEAD_GRAMMAR[a], (a, nxt)


def test_traced_run_reports_the_program_metrics(counts):
    correct, _, _, metrics, info, _, _ = _run(trace=True)
    assert correct and info['window_s'] > 0
    for name in ('serve_occupancy_pct', 'sampling_share_pct'):
        assert 0 < metrics[name][0] <= 100, name
    # the CPU has no device timeline: the device-time readers find nothing
    assert not {'txl_attn_roofline_pct', 'txl_serve_mfu'} & set(metrics)
    assert counts['serve.steps'] == tiny()[0]['trace']['steps']


def _ctx(reading):
    _, cfg = tiny()
    return {'reading': reading, 'cfg': cfg, 'cell': tiny()[0], 'work': work,
            'counts': {'vocab': 216}}


def _attn_reading():
    """One 'emodis.serve.step' range of 15 us holding an 'emodis.txl.attn'
    range of 10 us, in which an operator launched a kernel of 4 us; in the
    step past the attention one of 2 us, and after the step one of 3 us
    (the window's end at 30 us)."""
    E = _Event
    return Reading([E(0, 15_000, 'emodis.serve.step', 'user_annotation', 4),
                    E(0, 10_000, 'emodis.txl.attn', 'user_annotation', 1),
                    E(1_000, 2_000, 'aten::bmm', 'cpu_op', 2),
                    E(12_000, 13_000, 'aten::add', 'cpu_op', 3),
                    E(20_000, 21_000, 'aten::copy_', 'cpu_op', 5),
                    E(3_000, 7_000, 'gemm', 'kernel', 90, link=2),
                    E(14_000, 16_000, 'add', 'kernel', 91, link=3),
                    E(27_000, 30_000, 'copy', 'kernel', 92, link=5)], steps=1)


@pytest.mark.parametrize('metric', ['txl_attn_roofline_pct', 'txl_serve_mfu'])
def test_reader_finds_nothing_without_the_program_counts(metric, counts):
    assert common.metric_reader(metric).read(_ctx(_attn_reading())) is None


@pytest.mark.parametrize('metric', ['txl_attn_roofline_pct', 'txl_serve_mfu'])
def test_reader_finds_nothing_without_its_span(metric, counts):
    counts.update({'serve.steps': 2, 'serve.slot_steps': 10,
                   'serve.live_rows': 100})
    E = _Event
    r = Reading([E(1_000, 2_000, 'aten::bmm', 'cpu_op', 2),
                 E(3_000, 7_000, 'gemm', 'kernel', 90, link=2)], steps=1)
    assert common.metric_reader(metric).read(_ctx(r)) is None


def test_readers_read_the_span_and_the_counts(counts):
    counts.update({'serve.steps': 2, 'serve.slot_steps': 10,
                   'serve.live_rows': 100})
    _, cfg = tiny()
    ctx = _ctx(_attn_reading())
    nbytes = work_txl.attn_bytes(cfg, 2, 10, 100, 2)
    assert common.metric_reader('txl_attn_roofline_pct').read(ctx) == \
        pytest.approx(100.0 * nbytes / work.HBM_BYTES_PER_S / 4e-6)
    flops, nb = work_txl.step_work(cfg, 216, 2, 10, 100, 2)
    # over the 6 us the step launched, not the 30 us window
    assert common.metric_reader('txl_serve_mfu').read(ctx) == pytest.approx(
        100.0 * work.least_seconds(flops, nb, 'bfloat16') / 6e-6)


def test_attention_bytes_count_the_live_prefix():
    """Two layers, one step of two slots at clocks 3 and 5: 4 + 6 rows of k
    and v read, 2 of each written, and the position heads of the distances
    up to the mean clock 4, in bf16 at d_model 8."""
    cfg = {'n_layer': 2, 'd_model': 8}
    got = work_txl.attn_bytes(cfg, steps=1, slot_steps=2, live_rows=8, elem=2)
    assert got == 2 * 8 * 2 * (2 * 10 + 2 * 2 + 5)
    assert work_txl.attn_flops(cfg, slot_steps=2, live_rows=8) == 2 * 6 * 8 * 10


@pytest.mark.card
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    out = subprocess.run([sys.executable, str(common.HERE / 'run.py'),
                          '--workload', CELL, '--seed', '2718281828',
                          '--seconds', '3', '--trace', '0'],
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])['correct']
