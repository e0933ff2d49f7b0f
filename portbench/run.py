"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's inputs from the seed, sets up the program (every shape
the window uses is warmed up; that and any build is ``setup_s``), measures
for ``--seconds`` seconds, checks what the window produced against the
plain reference, and prints one JSON line last on standard output.  With
``--trace 0`` its metrics are the cell's end-to-end metrics; with
``--trace 1`` a profiler records a fixed number of the window's steps and
the metrics are the cell's per-layer ones, each read by its file under
``portbench/metrics/``.  The numbers compared for ``correct`` end standard
error and the result line, each with its limit.

Exits non-zero with no result when no card is present, when the program is
absent, or when JAX or the JAX package was loaded into the process.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import common, work  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'unknown'


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             bench=None, cell=None, cfg=None, fault=None):
    """Set up, measure and check one cell.  Returns (correct, attempted,
    failed, metrics, device info, compared, breakdown or None)."""
    import torch
    from portbench.trace import Trace

    bench = bench or common.benchmark()
    cell = cell or common.workload(name)
    cfg = cfg or common.config(cell['config'])
    cuda = torch.device(device).type == 'cuda'
    t0 = time.perf_counter()
    drv = common.driver(cell['driver']).Driver(cell, cfg, seed, device, fault)
    setup_s = time.perf_counter() - t0
    try:
        tr = Trace(**cell['trace']) if trace else None
        e2e = drv.run_window(seconds, tr)
        reading = tr.close() if tr else None
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        counts = drv.counts()
        drv.release()
        correct, compared = drv.check()
    finally:
        drv.close()
    info = {'platform': 'gpu' if cuda else 'cpu',
            'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
            'count': 1, 'memory_peak_bytes': int(peak)}
    metrics, breakdown = {}, None
    if trace:
        info['busy_s'] = reading.busy_s
        info['window_s'] = reading.window_s
        ctx = {'reading': reading, 'cfg': cfg, 'cell': cell, 'counts': counts,
               'work': work}
        for m in common.cell_metrics(bench, name, 'per_layer'):
            value = common.metric_reader(m['name']).read(ctx)
            if value is not None:
                metrics[m['name']] = (value, m['unit'])
        breakdown = reading.breakdown()
    else:
        e2e['setup_s'] = (setup_s, 's')
        for m in common.cell_metrics(bench, name, 'end_to_end'):
            if m['name'] in e2e:
                metrics[m['name']] = (e2e[m['name']][0], m['unit'])
    return (correct, drv.attempted, drv.failed, metrics, info, compared,
            breakdown)


def main(argv=None) -> int:
    args = parse(argv)
    common.set_cache_dirs()
    # one host thread for torch's CPU operators: the program's host work is
    # one Python thread, and idle worker threads that spin on the shared
    # cores stretched the training steps' tail (p95 +5-12% on the card)
    os.environ['OMP_NUM_THREADS'] = '1'
    bench = common.benchmark()
    entry = {w['name']: w for w in bench['workloads']}.get(args.workload)
    if entry is None:
        print(f'no cell {args.workload!r} in BENCHMARK.json', file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry['chips']:
        print(f'{args.workload} needs {entry["chips"]} CUDA device(s); '
              f'found {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    (correct, attempted, failed, metrics, info, compared,
     breakdown) = run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), 'cuda', bench)
    bad = common.forbidden_modules()
    if bad:
        print(f'forbidden modules loaded: {", ".join(bad)}', file=sys.stderr)
        return 3
    info['power'] = power_limit()
    print(f'card: {info["power"]}', file=sys.stderr)
    for k, v in compared.items():
        print(f'compared {k}: {v["value"]!r} (limit {v["limit"]!r})',
              file=sys.stderr)
    sys.stderr.flush()
    print(common.result_line(correct, attempted, failed, metrics, info,
                             compared, breakdown), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
