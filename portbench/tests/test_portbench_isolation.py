"""Nothing the harness loads is JAX, flax or the JAX package (compared by
whole top-level names, so the port passes), the plain reference imports
nothing of the port, and no harness file reads the repository's JAX-era
benchmark files."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import common

HERE = Path(common.__file__).resolve().parent


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'emo_disentanger_tpu_torch_fake', object())
    monkeypatch.setitem(sys.modules, 'jaxtyping_fake', object())
    assert 'emo_disentanger_tpu' not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'emo_disentanger_tpu.core', object())
    assert 'emo_disentanger_tpu' in common.forbidden_modules()


def test_harness_process_loads_nothing_forbidden():
    code = ('import sys, json; sys.path.insert(0, %r);'
            'from portbench import common, run, calibrate, trace;'
            '[common.driver(d) for d in ("train", "serve")];'
            '[common.metric_reader(m["name"]) for m in common.benchmark()["per_layer"]];'
            'import emo_disentanger_tpu_torch.infer.stage2_batch,'
            ' emo_disentanger_tpu_torch.train.trainer;'
            'print(json.dumps(common.forbidden_modules()))' % str(common.ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, cwd='/')
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ('.' * node.level) + (node.module or '')


def test_reference_imports_no_program():
    for path in (HERE / 'reference').glob('*.py'):
        for name in _imports(path):
            top = name.lstrip('.').split('.')[0]
            assert top in ('', 'models', '__future__', 'math', 'os', 'pickle',
                           'typing', 'collections', 'numpy', 'torch'), (path, name)


def test_no_harness_file_reads_the_jax_era_bench_files():
    needle = 'BENCH' + '_'
    for path in HERE.rglob('*.py'):
        assert needle not in path.read_text(), path
        for name in _imports(path):
            assert not name.split('.')[0].startswith(('bench', 'chip_smoke',
                                                      'kernel_'))
