"""The readers of the program's spans and counters: each gives its value on
a hand-built reading, nothing where its spans or counts are absent, and a
traced tiny run of each cell kind reports them."""

import pytest
import torch

from portbench import common, run
from portbench.tests.tiny import tiny
from portbench.trace import Reading

torch.set_num_threads(2)


@pytest.fixture
def counts():
    from emo_disentanger_tpu_torch.utils.profiling import COUNTS
    COUNTS.clear()
    yield COUNTS
    COUNTS.clear()


def _reading(host, window_s=1e-3):
    """Host ranges (start, end in microseconds, name) over a window."""
    r = Reading.__new__(Reading)
    r.host = [(a, b, name, 0) for a, b, name in host]
    r.window_s = window_s
    r.steps = 4
    return r


def _read(metric, reading, slots=4):
    ctx = {'reading': reading, 'cell': {'traffic': {'slots': slots}},
           'cfg': {}, 'counts': {}}
    return common.metric_reader(metric).read(ctx)


# two steps of 100 us with a sampler of 10 and of 30 (20 of it inside the
# step), a refill of 50 and one that overlaps it by 10, two batches of 100
# and 150, over a window of 1 ms
HOST = [(0, 100, 'emodis.serve.step'), (20, 30, 'emodis.serve.sample'),
        (200, 300, 'emodis.serve.step'), (280, 310, 'emodis.serve.sample'),
        (400, 450, 'emodis.serve.refill'), (440, 500, 'emodis.serve.refill'),
        (0, 1000, 'ProfilerStep#1'), (500, 600, 'emodis.data.batch'),
        (700, 850, 'emodis.data.batch'), (710, 720, 'aten::stack')]


@pytest.mark.parametrize('metric,want', [
    ('refill_pct.serve', 100.0 * 100 / 1000),
    ('sampling_share_pct', 100.0 * 30 / 200),
    ('loader_pct.train', 100.0 * 250 / 1000),
])
def test_span_reader_on_a_hand_built_reading(metric, want):
    assert _read(metric, _reading(HOST)) == pytest.approx(want)


@pytest.mark.parametrize('metric', ['refill_pct.serve', 'sampling_share_pct',
                                    'loader_pct.train', 'serve_occupancy_pct'])
def test_reader_finds_nothing_without_its_spans_or_counts(metric, counts):
    others = [h for h in HOST if not h[2].startswith('emodis.')]
    assert _read(metric, _reading(others)) is None


def test_occupancy_reads_the_program_counts(counts):
    counts.update({'serve.steps': 10, 'serve.slot_steps': 31})
    assert _read('serve_occupancy_pct', _reading([]), slots=4) == pytest.approx(
        100.0 * 31 / 40)


def test_occupancy_finds_nothing_in_a_program_without_counts(monkeypatch):
    import emo_disentanger_tpu_torch.utils.profiling as prof
    monkeypatch.delattr(prof, 'COUNTS')
    assert _read('serve_occupancy_pct', _reading(HOST)) is None


@pytest.mark.parametrize('cell,names', [
    ('performer.serve', {'serve_occupancy_pct', 'sampling_share_pct'}),
    ('gpt2.train', {'loader_pct.train'}),
])
def test_traced_tiny_run_reports_the_program_metrics(cell, names, counts):
    c, cfg = tiny(cell)
    _, _, _, metrics, *_ = run.run_cell(cell, 2 ** 33 + 7, 0.5, True, 'cpu',
                                        cell=c, cfg=cfg)
    assert names <= set(metrics)
    for name in names:
        assert 0 < metrics[name][0] <= 100
