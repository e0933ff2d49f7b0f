"""The cells ``tests/test_portbench_run.py`` is collected over.

That module parametrises its tests over every cell of ``BENCHMARK.json``
at import, and looks up each cell's faults (``FAULTS``) and tiny size
(``tests/tiny.py``), which know the stage-2 drivers ``train`` and
``serve`` alone; a cell of another driver would stop the module from
loading.  While it is collected it sees those drivers' cells, and the
other drivers' cells have modules of their own (``txl.serve``:
``tests/test_portbench_txl.py``).  This file and ``pytest.ini`` beside it
go once ``FAULTS`` and ``tiny()`` know every driver.
"""

import pytest

from portbench import common

RUN_DRIVERS = ('train', 'serve')


@pytest.hookimpl(hookwrapper=True)
def pytest_make_collect_report(collector):
    if not (isinstance(collector, pytest.Module)
            and collector.path.name == 'test_portbench_run.py'):
        yield
        return
    whole = common.benchmark

    def benchmark():
        bench = whole()
        return {**bench, 'workloads': [
            w for w in bench['workloads']
            if common.workload(w['name'])['driver'] in RUN_DRIVERS]}
    common.benchmark = benchmark
    try:
        yield
    finally:
        common.benchmark = whole
