"""BENCHMARK.json and the files it names: every cell, configuration and
metric is found from its own file, and names and units keep to the
characters the result line allows."""

import re

import pytest

from portbench import common

BENCH = common.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


@pytest.mark.parametrize('cell', CELLS)
def test_cell_files_found_by_name(cell):
    w = common.workload(cell)
    entry = {x['name']: x for x in BENCH['workloads']}[cell]
    assert w['config'] == entry['config']
    cfg = common.config(w['config'])
    assert cfg['name'] == w['config']
    assert hasattr(common.driver(w['driver']), 'Driver')
    e2e = [m['name'] for m in common.cell_metrics(BENCH, cell, 'end_to_end')]
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert common.cell_metrics(BENCH, cell, 'per_layer')
    assert set(w['limits']) and all(isinstance(v, (int, float))
                                    for v in w['limits'].values())


@pytest.mark.parametrize('metric', [m['name'] for m in BENCH['per_layer']])
def test_metric_reader_found_by_name(metric):
    assert callable(common.metric_reader(metric).read)


def test_names_units_and_limits():
    for section in ('end_to_end', 'per_layer'):
        for m in BENCH[section]:
            assert NAME.match(m['name']) and UNIT.match(m['unit'])
            assert m['better'] in ('lower', 'higher')
            assert set(m.get('workloads', CELLS)) <= set(CELLS)
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
    for c in BENCH['configs']:
        assert NAME.match(c['name']) and c['reduced'] == []
        assert c['file'] == f'portbench/configs/{c["name"]}.json'
    assert {w['config'] for w in BENCH['workloads']} == {c['name'] for c in BENCH['configs']}
    assert all(w['chips'] == 1 for w in BENCH['workloads'])
    moves = {m['name'] for m in BENCH['end_to_end']}
    assert all(m['moves'] in moves for m in BENCH['per_layer'])


@pytest.mark.parametrize('bad', ['../x', 'a/b', '', ' x', 'x' * 65])
def test_names_cannot_leave_their_folder(bad):
    with pytest.raises(ValueError):
        common.workload(bad)
