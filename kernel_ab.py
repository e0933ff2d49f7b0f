#!/usr/bin/env python3
"""Hold the port's head-major FAVOR+ kernels (#1-#4) of two checkouts against
each other on one GPU: the same seeded inputs, outputs compared bit for bit,
and each kernel's time.

    python3 kernel_ab.py --save OUT.pt [--root DIR]   # the port under DIR (default: here)
    python3 kernel_ab.py --compare A.pt B.pt [C.pt ...]

``--save`` builds the kernels of ``DIR/emo_disentanger_tpu_torch`` (into
``DIR/build/kernels``), runs ``favor_kmax``, ``favor_fwd``, ``favor_bwd_a``
and ``favor_bwd_b`` through their wrappers at the shapes of the kernel table
in PERF.md (bf16: kmax and fwd at B=2 L=1024 and B=16 L=2048, the backward
passes at B=16 L=3072; f32 at a ragged L=1000), and saves their outputs and
CUDA-event times.  ``--compare`` reports, against the first file, which
outputs differ and each time's ratio.  Run the two checkouts in turns in one
call (A, B, B, A), since cards and their power limits differ between calls.
"""

import argparse
import os
import sys

import torch

N_HEAD, D_HEAD, FAVOR = 8, 64, 128
CASES = (('bf16', 2, 1024, ('fwd',)), ('bf16', 16, 2048, ('fwd',)),
         ('bf16', 16, 3072, ('bwd',)), ('f32', 2, 1000, ('fwd', 'bwd')))


def time_ms(fn, target_ms=100.0):
    """Mean time of one call from CUDA events around enough calls to fill
    about ``target_ms`` (at least 5), after a short first timing."""
    def run(iters):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / iters
    first = run(3)
    return run(max(5, min(500, int(target_ms / max(first, 1e-3)))))


def save(root, path):
    sys.path.insert(0, os.path.abspath(root))
    from emo_disentanger_tpu_torch.ops import _build
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    _build.build(['favor_fwd', 'favor_bwd'])
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(21)
    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    outs, times = {}, {}
    for dt, B, L, what in CASES:
        dtype = torch.bfloat16 if dt == 'bf16' else torch.float32
        q, k, v, g = [(0.5 * torch.randn(B * N_HEAD, L, D_HEAD, generator=gen)
                       ).to(dev, dtype) for _ in range(4)]
        tag = f'{dt} B={B} L={L}'
        part = la._favor_kmax_cuda(k, omega)
        outs[f'favor_kmax {tag}'] = part
        if 'fwd' in what:
            outs[f'favor_fwd {tag}'] = la._favor_fwd_cuda(q, k, v, omega, part)
            times[f'favor_kmax {tag}'] = time_ms(lambda: la._favor_kmax_cuda(k, omega))
            times[f'favor_fwd {tag}'] = time_ms(
                lambda: la._favor_fwd_cuda(q, k, v, omega, part))
        if 'bwd' in what:
            dq, u, w = la._favor_bwd_a_cuda(q, k, v, g, omega, part)
            dk, dv = la._favor_bwd_b_cuda(q, k, v, u, w, omega, part)
            for name, t in (('dq', dq), ('u', u), ('w', w), ('dk', dk), ('dv', dv)):
                outs[f'favor_bwd {name} {tag}'] = t
            times[f'favor_bwd_a {tag}'] = time_ms(
                lambda: la._favor_bwd_a_cuda(q, k, v, g, omega, part))
            times[f'favor_bwd_b {tag}'] = time_ms(
                lambda: la._favor_bwd_b_cuda(q, k, v, u, w, omega, part))
    torch.cuda.synchronize()
    torch.save({'root': os.path.abspath(root), 'device': torch.cuda.get_device_name(0),
                'outs': {n: t.cpu() for n, t in outs.items()}, 'times': times}, path)
    print(f'kernel_ab: {root}: ' + ', '.join(f'{n} {t:.4f} ms' for n, t in times.items()))


def compare(paths):
    runs = [torch.load(p, weights_only=True) for p in paths]
    ref = runs[0]
    for p, run in zip(paths[1:], runs[1:]):
        differ = [n for n, t in ref['outs'].items() if not torch.equal(t, run['outs'][n])]
        ratios = ', '.join(f'{n} {run["times"][n] / t:.4f}' for n, t in ref['times'].items())
        print(f'kernel_ab: {p} vs {paths[0]}: '
              f'{"all outputs bitwise equal" if not differ else "differ: " + str(differ)}; '
              f'time ratios {ratios}')
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--save')
    ap.add_argument('--root', default='.')
    ap.add_argument('--compare', nargs='+')
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    if not args.save:
        ap.error('give --save or --compare')
    if not torch.cuda.is_available():
        print('kernel_ab: CUDA is not available', file=sys.stderr)
        return 1
    save(args.root, args.save)
    return 0


if __name__ == '__main__':
    sys.exit(main())
