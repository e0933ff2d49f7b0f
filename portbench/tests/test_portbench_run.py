"""The harness end to end at a tiny size on the CPU (the look for a card
skipped): each cell's run, its result line, the window's arithmetic, the
refusal without a card, each fault a cell can have, and each cell's
control coming out not correct."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import common, run
from portbench.reference import models, train as ref_train
from portbench.tests.tiny import tiny

torch.set_num_threads(2)
CELLS = [w['name'] for w in common.benchmark()['workloads']]
FAULTS = {'train': ('frozen', 'half_batch'), 'serve': ('frozen', 'token')}
KEY = r'^[A-Za-z0-9_.\-]+$'


def _run(cell, trace=False, fault=None, seed=2 ** 32 + 12345):
    c, cfg = tiny(cell)
    return run.run_cell(cell, seed, 0.5, trace, 'cpu', cell=c, cfg=cfg,
                        fault=fault)


@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs_correct_with_its_metrics(cell):
    import re
    correct, attempted, failed, metrics, info, compared, _ = _run(cell)
    assert correct and attempted > 0 and failed == 0, compared
    bench = common.benchmark()
    want = {m['name']: m['unit'] for m in common.cell_metrics(bench, cell, 'end_to_end')}
    assert {k: u for k, (_, u) in metrics.items()} == want
    assert all(v > 0 for v, _ in metrics.values())
    line = json.loads(common.result_line(correct, attempted, failed, metrics,
                                         info, compared))
    assert list(line)[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert list(line)[-1] == 'compared'
    for k, m in line['metrics'].items():
        assert re.match(KEY, k) and re.match(r'^[A-Za-z0-9_/%.\-]{1,16}$', m['unit'])
    assert {'platform', 'kind', 'count', 'memory_peak_bytes'} <= set(line['device'])


@pytest.mark.parametrize('cell', ['performer.train', 'performer.serve',
                                  'gpt2.serve'])
def test_traced_run_reads_the_profile(cell):
    correct, _, _, metrics, info, _, breakdown = _run(cell, trace=True)
    assert correct
    assert info['window_s'] > 0
    assert set(breakdown) == {'device_ops', 'idle_gaps'}
    # the CPU has no device timeline: a roofline finds nothing to read
    assert all(not k.endswith('roofline_pct') for k in metrics)
    # every traced step taken, the step's share of the peak read over them
    assert {'train_mfu', 'serve_mfu'} & set(metrics)


@pytest.mark.parametrize('cell,fault', [(c, f) for c in CELLS
                                        for f in FAULTS[common.workload(c)['driver']]])
def test_fault_comes_out_not_correct(cell, fault):
    correct, *_, compared, _ = _run(cell, fault=fault)
    assert not correct, compared


@pytest.mark.parametrize('cell', ['performer.train', 'gpt2.train'])
def test_training_control_is_not_correct(cell):
    c, cfg = tiny(cell)
    drv = common.driver('train').Driver(c, cfg, 77, 'cpu', program=False)
    try:
        got = ref_train.compare(drv.reference(quant=models.fp8), drv.reference())
    finally:
        drv.close()
    assert any(got[k] > c['limits'][k] for k in c['limits']), got


@pytest.mark.parametrize('cell', ['performer.serve', 'gpt2.serve'])
def test_serving_control_is_not_correct(cell):
    c, cfg = tiny(cell)
    drv = common.driver('serve').Driver(c, cfg, 78, 'cpu')
    drv.run_window(0.0)
    drv.release()
    gaps = drv.gaps(quant=models.fp8, control=True)
    assert gaps.max() > c['limits']['gap']


def test_train_window_counts_every_step_over_the_whole_wall(monkeypatch):
    import time as _time
    train = common.driver('train')
    drv = train.Driver.__new__(train.Driver)
    drv.B, drv.L = 2, 5
    walls = iter([0.01] * 19 + [0.3])
    clock = [0.0]

    def step():
        w = next(walls)
        clock[0] += w + 0.001             # host work between steps
        return 1.0, w
    drv.one_step = step
    monkeypatch.setattr(_time, 'perf_counter', lambda: clock[0])
    e2e = drv.run_window(0.49)
    assert drv.attempted == 20
    assert e2e['train_tokens_per_s'][0] == pytest.approx(20 * 10 / clock[0])
    assert e2e['train_step_p95_ms'][0] == pytest.approx(
        1e3 * common.p95([0.01] * 19 + [0.3]))


def test_serve_window_takes_whole_calls_of_the_queue(monkeypatch):
    """Each call submits the cell's queue; calls go on while at least half
    a call's time is left; the counts come from the calls' stats."""
    import time as _time
    serve = common.driver('serve')
    drv = serve.Driver.__new__(serve.Driver)
    drv.t = {'queue': 6, 'bars': [1, 2]}
    drv.e2w, _ = common.load_module(common.HERE / 'traffic.py').dictionary()
    drv.rng = __import__('numpy').random.RandomState(0)
    drv.s, drv.calls, drv.V = [0] * 8, 0, 327
    clock = [0.0]
    sizes = []

    class Gen:
        def serve(self, primers, sheets, seed):
            sizes.append(len(primers))
            clock[0] += 3.0
            n = [len(p) + 1 + 10 for p in primers]
            return ([[0] * k for k in n],
                    {'wall_seconds': 3.0, 'steps': 40, 'chunks': 2,
                     'events': n, 'rejects': [1] * len(n),
                     'status': [2] * len(n)})
    drv.gen = Gen()
    monkeypatch.setattr(_time, 'perf_counter', lambda: clock[0])
    e2e = drv.run_window(7.4)              # 3, 6, then 1.4 s left < 1.5
    assert sizes == [6, 6] and drv.attempted == 12 and drv.failed == 0
    assert e2e['gen_events_per_s'][0] == pytest.approx(12 * 10 / 6.0)
    n = len([0, 0, 0]) + 1 + 10
    assert drv.counts()['steps'] == 80
    assert drv.counts()['slot_steps'] == 12 * (n + 1)
    assert drv.counts()['live_rows'] == 12 * n * (n + 1) // 2
    drv.run_window(7.6)                    # 1.6 s left: a third call
    assert sizes[2:] == [6, 6, 6]


@pytest.mark.parametrize('same', [False, True])
def test_song_sizes_are_the_seeds_alike(same):
    """Every seed asks for the same sizes; with ``same_sizes`` also in the
    same order, bar by bar, and only the events differ."""
    import numpy as np
    traffic = common.load_module(common.HERE / 'traffic.py')
    e2w, _ = traffic.dictionary()
    shape = lambda sheets: [[len(b) for b in s] for s in sheets]
    a = traffic.jobs(e2w, 40, 8, 24, np.random.RandomState(1), same)[1]
    b = traffic.jobs(e2w, 40, 8, 24, np.random.RandomState(2), same)[1]
    assert sorted(map(len, a)) == sorted(map(len, b))
    assert (shape(a) == shape(b)) == same and a != b


def test_serve_call_refills_slots_from_the_queue():
    c, cfg = tiny('performer.serve')
    assert c['traffic']['queue'] > c['traffic']['slots']
    drv = common.driver('serve').Driver(c, cfg, 5, 'cpu')
    drv.run_window(0.0)
    assert drv.calls == 1 and drv.attempted == c['traffic']['queue']
    assert drv.failed == 0
    assert drv.counts()['slot_steps'] > drv.counts()['steps'] * c['traffic']['slots'] / 2


def test_idle_gaps_named_by_the_innermost_open_host_range():
    from portbench.trace import Reading
    r = Reading.__new__(Reading)
    ev = lambda a, b, name: (a, b, name, 0)
    r.host = [ev(0, 100, 'outer'), ev(10, 30, 'inner'), ev(0, 100, 'same'),
              ev(60, 70, 'late')]
    r.merged = [(0, 5), (15, 20), (40, 45), (62, 63), (80, 90)]
    got = dict(r.idle_gaps())
    # gaps of 10 and 20 at 10 and 30 fall in 'inner'; of 17 at 53.5 and
    # 71.5 in 'same' (nested in 'outer', and 'late' has closed by 71.5)
    assert got == pytest.approx({'inner': 30e-6, 'same': 34e-6})


class _Event:
    """A raw profiler event as ``Reading`` reads it (times in ns)."""

    def __init__(self, a, b, name, kind, cid=0, link=0):
        from torch.autograd import DeviceType
        self.a, self.b, self._name = a, b, name
        self.cid, self.link = cid, link
        self.dev = DeviceType.CPU if kind in ('cpu_op', 'user_annotation',
                                              'cuda_runtime') else DeviceType.CUDA

    def name(self): return self._name
    def start_ns(self): return self.a
    def end_ns(self): return self.b
    def device_type(self): return self.dev
    def correlation_id(self): return self.cid
    def linked_correlation_id(self): return self.link


def test_reading_of_raw_events():
    """Busy time is the union of device operations; annotations are no
    device work; an operator's device time takes what its children
    launched."""
    from portbench.trace import Reading
    E = _Event
    r = Reading([E(0, 10_000, 'portbench.step', 'user_annotation', 1),
                 E(0, 10_000, 'portbench.step', 'gpu_user_annotation'),
                 E(1_000, 5_000, 'aten::einsum', 'cpu_op', 2),
                 E(2_000, 3_000, 'aten::bmm', 'cpu_op', 3),
                 E(6_000, 7_000, 'aten::add', 'cpu_op', 4),
                 E(2_500, 2_600, 'cudaLaunchKernel', 'cuda_runtime', 9),
                 E(3_000, 5_000, 'gemm', 'kernel', 90, link=3),
                 E(4_000, 6_000, 'copy', 'gpu_memcpy', 91, link=2),
                 E(8_000, 9_000, 'add', 'kernel', 92, link=4)], steps=1)
    assert r.busy_s == pytest.approx(4e-6)
    assert r.window_s == pytest.approx(10e-6)
    assert r.op_device_seconds('aten::einsum') == pytest.approx(4e-6)
    assert r.kernel_seconds(['gemm', 'add']) == pytest.approx(3e-6)
    assert r.idle_gaps() == [['aten::add', pytest.approx(2e-6)]]


def test_window_rate_and_p95_take_every_step():
    walls = [0.1] * 95 + [1.0] * 5
    assert common.p95(walls) == pytest.approx(0.1 + 0.05 * 0.9)
    assert common.p95([0.2]) == 0.2


def test_measurement_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    out = subprocess.run([sys.executable, str(common.HERE / 'run.py'),
                          '--workload', CELLS[0], '--seed', '1', '--seconds',
                          '1', '--trace', '0'], capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ''


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    out = subprocess.run([sys.executable, str(common.HERE / 'run.py'),
                          '--workload', cell, '--seed', '2718281828',
                          '--seconds', '3', '--trace', '0'],
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])['correct']
