"""The harness's shared pieces: where things are, how a cell's files are
found by name, the checks every run makes (device, isolation), the cache
directories, and the statistics of a window.

Everything that belongs to one cell, configuration or per-layer metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``portbench/workloads/<cell>.json``: the cell's configuration, driver and
  traffic parameters;
* ``portbench/configs/<config>.json``: the configuration's sizes;
* ``portbench/drivers/<driver>.py``: the traffic driver (``train``, ``serve``);
* ``portbench/metrics/<metric>.py``: a per-layer metric's reader.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names the measured process may never hold: the JAX
# package the port was made from, and JAX itself.  Compared whole, so the
# port (emo_disentanger_tpu_torch) is not one of them.
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'emo_disentanger_tpu')


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / 'BENCHMARK.json')


def check_name(name: str) -> str:
    """A cell, configuration or metric name as the contract allows it, so
    that it can only name a file inside its folder."""
    ok = (0 < len(name) <= 64 and (name[0].isalnum() or name[0] == '_')
          and all(c.isascii() and (c.isalnum() or c in '_.-') for c in name))
    if not ok:
        raise ValueError(f'bad name {name!r}')
    return name


def workload(name: str) -> dict:
    return load_json(HERE / 'workloads' / f'{check_name(name)}.json')


def config(name: str) -> dict:
    return load_json(HERE / 'configs' / f'{check_name(name)}.json')


def load_module(path: Path) -> ModuleType:
    """Import a file by path (metric files have dots in their names)."""
    name = 'portbench_' + path.stem.replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str) -> ModuleType:
    return load_module(HERE / 'drivers' / f'{check_name(kind)}.py')


def metric_reader(name: str) -> ModuleType:
    return load_module(HERE / 'metrics' / f'{check_name(name)}.py')


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` ('end_to_end' or 'per_layer') that
    ``cell`` reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if cell in m.get('workloads', [cell])]


def forbidden_modules() -> List[str]:
    """The forbidden top-level names present in ``sys.modules``."""
    tops = {name.split('.')[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def set_cache_dirs() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, so that only a checkout's first run builds.  The port builds its
    CUDA kernels into ``build/kernels/`` of the checkout by itself."""
    cache = ROOT / 'build' / 'portbench-cache'
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['CUDA_CACHE_PATH'] = str(cache / 'cuda')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def p95(values: List[float]) -> float:
    """The 95th percentile of every value (``statistics.quantiles`` with
    100 cut points, inclusive of the extremes)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method='inclusive')[94]


def seeds(seed: int, n: int) -> List[int]:
    """``n`` 32-bit seeds derived from a seed of any size (a negative one
    taken modulo 2**64)."""
    import numpy as np
    return [int(s) for s in
            np.random.SeedSequence(seed % 2 ** 64).generate_state(n)]


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, tuple], device: dict,
                compared: Dict[str, dict], breakdown: Optional[dict] = None
                ) -> str:
    """The run's last line: ``metrics`` maps a name to (value, unit); the
    numbers compared for ``correct`` come last, each with its limit."""
    out = {'correct': bool(correct), 'attempted': int(attempted),
           'failed': int(failed),
           'metrics': {k: {'value': v, 'unit': u}
                       for k, (v, u) in metrics.items()},
           'device': device}
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['compared'] = compared
    return json.dumps(out)
