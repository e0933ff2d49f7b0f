"""Readings that set a cell's limits, made on the card in one process over
several seeds (never part of a benchmark run).

    python3 portbench/calibrate.py --workload <cell> --what <what> --seeds 1,2,3

``--what``:
* ``program``: the numbers a sound run of the program gives (training: its
  checked updates; generation: one call at the cell's load);
* ``control``: the reference put in the program's place at the precision
  below the configuration's (float8 e4m3 operands for bfloat16): the same
  numbers, against the float32 reference;
* ``half_batch``: training with half of each batch left out and the mean
  taken over the rest, planted in the program.
One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import common  # noqa: E402
from portbench.reference import models as ref_models  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402


def reading(name: str, what: str, seed: int, device='cuda', cell=None, cfg=None):
    cell = cell or common.workload(name)
    cfg = cfg or common.config(cell['config'])
    drv_mod = common.driver(cell['driver'])
    if cell['driver'] == 'train':
        if what == 'control':
            drv = drv_mod.Driver(cell, cfg, seed, device, program=False)
            try:
                ref = drv.reference()
                low = drv.reference(quant=ref_models.fp8)
            finally:
                drv.close()
            return ref_train.compare(low, ref)
        drv = drv_mod.Driver(cell, cfg, seed, device,
                             fault=None if what == 'program' else what)
        try:
            drv.release()
            return ref_train.compare(drv.program, drv.reference())
        finally:
            drv.close()
    drv = drv_mod.Driver(cell, cfg, seed, device)
    drv.run_window(0.0)
    drv.release()
    if what == 'control':
        gaps = drv.gaps(quant=ref_models.fp8, control=True)
    else:
        gaps = drv.gaps()
    return {'gap': float(gaps.max()), 'chosen': int(gaps.size),
            'songs_longest': max(len(s['stream']) for s in drv.songs)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--what', required=True,
                   choices=('program', 'control', 'half_batch'))
    p.add_argument('--seeds', required=True)
    args = p.parse_args(argv)
    common.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print('calibrate needs a CUDA device', file=sys.stderr)
        return 2
    for seed in (int(x) for x in args.seeds.split(',')):
        t0 = time.perf_counter()
        out = reading(args.workload, args.what, seed)
        out.update(workload=args.workload, what=args.what, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
