#!/usr/bin/env python3
"""Hold the port's kernels of two checkouts against each other on one GPU:
the same seeded inputs, the outputs compared, and each kernel's time.

    python3 kernel_ab.py --save OUT.pt [--root DIR] [--kernels favor,decode,flash,cla]
    python3 kernel_ab.py --compare A.pt B.pt [C.pt ...]

``--save`` builds the kernels of ``DIR/emo_disentanger_tpu_torch`` (into
``DIR/build/kernels``) and runs them through their wrappers:

* ``favor``: the head-major FAVOR+ kernels #1-#4 (``favor_kmax``,
  ``favor_fwd``, ``favor_bwd_a``, ``favor_bwd_b``) at the shapes of the
  kernel table in PERF.md (bf16: kmax and fwd at B=2 L=1024 and B=16
  L=2048, all four at B=16 L=3072; f32 at a ragged L=1000), and the
  heads-last #8 ``favor_kmax_hl``, #9 ``favor_fwd_hl``, #10
  ``favor_bwd_a_hl`` and #11 ``favor_bwd_b_hl`` at B=16 L=3072 bf16 on the
  same values.  Under bf16, #2-#4 and #9-#11 take the partial maxima of
  the f32 key max on ``k.float()``, and pass B a (u, w) drawn from the
  seed, not pass A's, so that their outputs do not depend on the bf16 key
  max or on pass A.  Outputs are compared bit for bit, except the bf16 key
  max's (#1, #8), whose design changes the order of its sums: by the
  largest relative difference.  The key max is also timed as the
  profiler's device time beside the CUDA events;
* ``decode``: #12 ``performer_decode_layer``, one serving step of 12 layers
  at B=16 with bf16 weights from zero state; its output and the layers'
  (S, z) are compared by the largest relative difference, and its time is
  the device time a layer from torch.profiler beside CUDA events;
* ``flash``: #13 ``flash_attention_fwd`` at B=16 H=8 L=2048 f32, compared
  by the largest relative difference.
* ``cla``: the composed op's kernels #5 ``cla_fwd``, #6 ``cla_bwd_a`` and
  #7 ``cla_bwd_b`` in f32 on FAVOR+ features (M=128, Dv=64) at BH=128
  L=3072 and at B=2 L=1000 (BH=16); pass B is fed a (u, w) drawn from the
  seed, so its outputs do not depend on pass A.  All three are compared by
  the largest relative difference (#5's 3xTF32 design changed its sums).

It saves the outputs, the times and each built kernel's SASS
(``cuobjdump -sass``, by mangled name).  ``--compare`` reports, against
the first file, which outputs differ (bitwise ones) or by how much
(relative ones), each time's ratio, and which kernels' SASS differ.  Run the two checkouts in turns in one call
(A, B, B, A), since cards and their power limits differ between calls.
"""

import argparse
import os
import re
import shutil
import subprocess
import sys

import torch

N_HEAD, D_HEAD, FAVOR = 8, 64, 128
D_MODEL, D_FF, N_LAYER, SERVE_B = 512, 2048, 12, 16
FLASH_B, FLASH_L = 16, 2048
KERNELS = ('favor', 'decode', 'flash', 'cla')
CLA_CASES = ((16, 3072), (2, 1000))
CASES = (('bf16', 2, 1024, ('fwd',)), ('bf16', 16, 2048, ('fwd',)),
         ('bf16', 16, 3072, ('fwd', 'bwd')), ('f32', 2, 1000, ('fwd', 'bwd')))


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


def device_ms(fn, calls, reps=20):
    """Device ms per call of ``fn`` (which makes ``calls`` wrapped calls)
    from torch.profiler's kernel events over ``reps`` runs, and the device
    kernels per call; (None, 0) when the profiler saw no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]
    if not kern:
        return None, 0
    n = reps * calls
    return (sum(e.self_device_time_total for e in kern) / 1e3 / n,
            sum(e.count for e in kern) / n)


def save_favor(dev, gen, outs, times):
    """Returns the names of the outputs compared by relative difference."""
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    relative = []
    for dt, B, L, what in CASES:
        dtype = torch.bfloat16 if dt == 'bf16' else torch.float32
        q, k, v, g = [(0.5 * torch.randn(B * N_HEAD, L, D_HEAD, generator=gen)
                       ).to(dev, dtype) for _ in range(4)]
        tag = f'{dt} B={B} L={L}'
        part = la._favor_kmax_cuda(k, omega)
        outs[f'favor_kmax {tag}'] = part
        times[f'favor_kmax {tag}'] = time_ms(lambda: la._favor_kmax_cuda(k, omega))
        # at tens of microseconds CUDA events time the wrapper's host work too
        dev_ms, _ = device_ms(lambda: la._favor_kmax_cuda(k, omega), 1)
        if dev_ms is not None:
            times[f'favor_kmax device {tag}'] = dev_ms
        if dt == 'bf16':
            # the kernels after it take the f32 key max's partial maxima
            relative.append(f'favor_kmax {tag}')
            part = la._favor_kmax_cuda(k.float(), omega)
            outs[f'favor_kmax f32 of {tag}'] = part
        if 'fwd' in what:
            outs[f'favor_fwd {tag}'] = la._favor_fwd_cuda(q, k, v, omega, part)
            times[f'favor_fwd {tag}'] = time_ms(
                lambda: la._favor_fwd_cuda(q, k, v, omega, part))
        if 'bwd' in what:
            dq, u, w = la._favor_bwd_a_cuda(q, k, v, g, omega, part)
            u_in = (0.5 * torch.randn(B * N_HEAD, L, D_HEAD, generator=gen)).to(dev, dtype)
            w_in = (0.5 * torch.randn(B * N_HEAD, L, generator=gen)).to(dev, dtype)
            dk, dv = la._favor_bwd_b_cuda(q, k, v, u_in, w_in, omega, part)
            for name, t in (('dq', dq), ('u', u), ('w', w), ('dk', dk), ('dv', dv)):
                outs[f'favor_bwd {name} {tag}'] = t
            times[f'favor_bwd_a {tag}'] = time_ms(
                lambda: la._favor_bwd_a_cuda(q, k, v, g, omega, part))
            times[f'favor_bwd_b {tag}'] = time_ms(
                lambda: la._favor_bwd_b_cuda(q, k, v, u_in, w_in, omega, part))
            if dt == 'bf16':
                # #8-#11 on the same values, heads-last [B, L, H * Dh]; the
                # partial's rows b * H + h are the split heads'
                hq, hk, hv, hg, hu = (la._merge_heads(t, B) for t in (q, k, v, g, u_in))
                outs[f'favor_kmax_hl {tag}'] = la._favor_kmax_hl_cuda(hk, omega, N_HEAD)
                relative.append(f'favor_kmax_hl {tag}')
                times[f'favor_kmax_hl {tag}'] = time_ms(
                    lambda: la._favor_kmax_hl_cuda(hk, omega, N_HEAD))
                outs[f'favor_fwd_hl {tag}'] = la._favor_fwd_hl_cuda(hq, hk, hv, omega, part,
                                                                    N_HEAD)
                times[f'favor_fwd_hl {tag}'] = time_ms(
                    lambda: la._favor_fwd_hl_cuda(hq, hk, hv, omega, part, N_HEAD))
                hl_a = la._favor_bwd_a_hl_cuda(hq, hk, hv, hg, omega, part, N_HEAD)
                hl_b = la._favor_bwd_b_hl_cuda(hq, hk, hv, hu, w_in, omega, part, N_HEAD)
                for name, t in zip(('dq', 'u', 'w', 'dk', 'dv'), hl_a + hl_b):
                    outs[f'favor_bwd_hl {name} {tag}'] = t
                times[f'favor_bwd_a_hl {tag}'] = time_ms(
                    lambda: la._favor_bwd_a_hl_cuda(hq, hk, hv, hg, omega, part, N_HEAD))
                times[f'favor_bwd_b_hl {tag}'] = time_ms(
                    lambda: la._favor_bwd_b_hl_cuda(hq, hk, hv, hu, w_in, omega, part, N_HEAD))
    return relative


def save_decode(dev, gen, outs, times):
    """One 12-layer serving step at B=16, bf16 weights, from zero state;
    every output is compared by relative difference."""
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    from emo_disentanger_tpu_torch.ops import performer_decode as pd
    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    shapes = {'wq': (D_MODEL, D_MODEL), 'wk': (D_MODEL, D_MODEL),
              'wv': (D_MODEL, D_MODEL), 'wo': (D_MODEL, D_MODEL),
              'w1': (D_FF, D_MODEL), 'w2': (D_MODEL, D_FF), 'b1': (D_FF,)}
    layers = []
    for _ in range(N_LAYER):
        p = {}
        for key in pd.PARAM_KEYS:
            t = torch.randn(shapes.get(key, (D_MODEL,)), generator=gen)
            t = 1.0 + 0.1 * t if key in ('g1', 'g2') else 0.04 * t
            p[key] = t.to(dev, torch.bfloat16).contiguous()
        layers.append(p)
    S = torch.zeros(N_LAYER, SERVE_B, N_HEAD, D_HEAD, FAVOR, device=dev)
    z = torch.zeros(N_LAYER, SERVE_B, N_HEAD, FAVOR, device=dev)
    x = torch.randn(SERVE_B, D_MODEL, generator=gen).to(dev, torch.bfloat16)
    mask = (torch.rand(SERVE_B, generator=gen) > 0.2).float().to(dev)

    def step():
        h = x
        for i, p in enumerate(layers):
            h = pd._decode_layer_cuda(h, S[i], z[i], p, omega, mask, N_HEAD)
        return h
    tag = f'bf16 B={SERVE_B} {N_LAYER} layers'
    outs[f'decode out {tag}'] = step()
    outs[f'decode S {tag}'] = S.clone()
    outs[f'decode z {tag}'] = z.clone()
    times[f'decode events/layer {tag}'] = time_ms(step) / N_LAYER
    dev_ms, n = device_ms(step, N_LAYER)
    if dev_ms is not None:
        times[f'decode device/layer {tag}'] = dev_ms
        times[f'decode kernels/layer {tag}'] = n
    return [n for n in outs if n.startswith('decode ')]


def save_flash(dev, gen, outs, times):
    from emo_disentanger_tpu_torch.ops import flash_attention as fa
    q, k, v = [(2.0 * torch.randn(FLASH_B, N_HEAD, FLASH_L, D_HEAD, generator=gen)
                ).to(dev) for _ in range(3)]
    tag = f'f32 B={FLASH_B} H={N_HEAD} L={FLASH_L}'
    scale = D_HEAD ** -0.5
    outs[f'flash out {tag}'] = fa._flash_attention_cuda(q, k, v, scale)
    times[f'flash {tag}'] = time_ms(lambda: fa._flash_attention_cuda(q, k, v, scale))
    return [f'flash out {tag}']


def save_cla(dev, gen, outs, times):
    """#5-#7 in f32 at CLA_CASES; returns their outputs, compared by
    relative difference."""
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    omega = la.draw_orthogonal_features(D_HEAD, FAVOR, gen).to(dev)
    relative = []
    for B, L in CLA_CASES:
        BH = B * N_HEAD
        x = lambda D: (0.5 * torch.randn(BH, L, D, generator=gen)).to(dev)
        q = la.favor_features(x(D_HEAD), omega, is_query=True)
        k = la.favor_features(x(D_HEAD), omega, is_query=False)
        v, g, u = x(D_HEAD), x(D_HEAD), x(D_HEAD)
        w = (0.5 * torch.randn(BH, L, generator=gen)).to(dev)
        tag = f'f32 BH={BH} L={L}'
        outs[f'cla_fwd out {tag}'] = la._cla_fwd_cuda(q, k, v)
        relative.append(f'cla_fwd out {tag}')
        times[f'cla_fwd {tag}'] = time_ms(lambda: la._cla_fwd_cuda(q, k, v))
        dq, u_a, w_a = la._cla_bwd_a_cuda(q, k, v, g)
        dk, dv = la._cla_bwd_b_cuda(q, k, v, u, w)
        for name, t in (('dphi_q', dq), ('u', u_a), ('w', w_a), ('dphi_k', dk), ('dv', dv)):
            outs[f'cla_bwd {name} {tag}'] = t
            relative.append(f'cla_bwd {name} {tag}')
        times[f'cla_bwd_a {tag}'] = time_ms(lambda: la._cla_bwd_a_cuda(q, k, v, g))
        times[f'cla_bwd_b {tag}'] = time_ms(lambda: la._cla_bwd_b_cuda(q, k, v, u, w))
    return relative


SAVERS = {'favor': (('favor_fwd', 'favor_bwd'), save_favor),
          'decode': (('performer_decode',), save_decode),
          'flash': (('flash_attn_fwd',), save_flash),
          'cla': (('linear_attn',), save_cla)}


def kernel_keys(names):
    """{mangled name: the name two checkouts' kernels are matched by}: the
    demangled name (c++filt; the mangled one where it is missing) with the
    width-mode template arguments of the aligned instantiations dropped --
    the FAVOR+ kernels' ALIGNED ``, 0>`` and the decode GEMV's ``<T, 1|0,
    false>`` (LN, GEN) written as its former ``<T, true|false>`` -- so that
    these meet their kernels of before the widths."""
    tool = shutil.which('c++filt')
    if not tool or not names:
        return {n: n for n in names}
    plain = subprocess.run([tool], input='\n'.join(names), capture_output=True,
                           text=True, check=True).stdout.split('\n')
    keys = {}
    for n, d in zip(names, plain):
        d = d.replace(', 0>', '>')
        d = re.sub(r'gemv_kernel<(.*), ([01]), false>',
                   lambda m: f'gemv_kernel<{m.group(1)}, {"true" if m.group(2) == "1" else "false"}>',
                   d)
        keys[n] = d
    return keys


def sass_by_kernel(lib):
    """{kernel name: its SASS} of the built library ``lib``, each kernel
    under ``kernel_keys``' name; the hash nvcc puts in an anonymous
    namespace's name, which follows the source's path, is dropped so that
    two checkouts' names match."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    text = subprocess.run([tool, '-sass', str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and line.strip():
            out[name].append(line.strip())
    keys = kernel_keys(list(out))
    drop = lambda t: re.sub(r'_GLOBAL__N__[0-9a-f]{8}_', '_GLOBAL__N__', t)
    return {drop(keys[n]): drop('\n'.join(lines)) for n, lines in out.items()}


def save(root, path, kernels):
    sys.path.insert(0, os.path.abspath(root))
    from emo_disentanger_tpu_torch.ops import _build
    sources = [src for k in kernels for src in SAVERS[k][0]]
    _build.build(sources)
    sass = {n: t for src in sources for n, t in sass_by_kernel(_build._target(src)).items()}
    dev = torch.device('cuda')
    outs, times, relative = {}, {}, []
    for k in kernels:
        gen = torch.Generator().manual_seed(21)
        relative += SAVERS[k][1](dev, gen, outs, times)
    torch.cuda.synchronize()
    torch.save({'root': os.path.abspath(root), 'device': torch.cuda.get_device_name(0),
                'outs': {n: t.cpu() for n, t in outs.items()}, 'times': times,
                'relative': relative, 'sass': sass}, path)
    print(f'kernel_ab: {root}: ' + ', '.join(f'{n} {t:.4f}' for n, t in times.items()))


def compare(paths):
    runs = [torch.load(p, weights_only=True) for p in paths]
    ref = runs[0]
    rel = set(ref.get('relative', ()))
    for p, run in zip(paths[1:], runs[1:]):
        differ = [n for n, t in ref['outs'].items()
                  if n not in rel and not torch.equal(t, run['outs'][n])]
        diffs = ', '.join(
            f'{n} {float((run["outs"][n].float() - t.float()).abs().max() / t.float().abs().max()):.2e}'
            for n, t in ref['outs'].items() if n in rel)
        ratios = ', '.join(f'{n} {run["times"][n] / t:.4f}'
                           for n, t in ref['times'].items() if n in run['times'])
        bitwise = 'all bitwise outputs equal' if not differ else 'differ: ' + str(differ)
        sass = ref.get('sass', {})
        other = [n for n, t in sass.items() if run.get('sass', {}).get(n) != t]
        print(f'kernel_ab: {p} vs {paths[0]}: {bitwise}; largest relative '
              f'differences {diffs or "none"}; time ratios {ratios}; SASS identical '
              f'for {len(sass) - len(other)} of {len(sass)} kernels, differs for {other}')
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--save')
    ap.add_argument('--root', default='.')
    ap.add_argument('--compare', nargs='+')
    ap.add_argument('--kernels', default=','.join(KERNELS),
                    help='comma-separated, of ' + ', '.join(KERNELS))
    args = ap.parse_args()
    kernels = args.kernels.split(',')
    if not set(kernels) <= set(KERNELS):
        ap.error(f'--kernels takes {", ".join(KERNELS)}')
    if args.compare:
        return compare(args.compare)
    if not args.save:
        ap.error('give --save or --compare')
    if not torch.cuda.is_available():
        print('kernel_ab: CUDA is not available', file=sys.stderr)
        return 1
    save(args.root, args.save, kernels)
    return 0


if __name__ == '__main__':
    sys.exit(main())
