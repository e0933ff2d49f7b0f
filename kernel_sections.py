#!/usr/bin/env python3
"""Where the FAVOR+ forward's and backward passes' time goes inside a
chunk, on the GPU, and the composed op's (``--cla``); and the bf16 key max
at each number of chunks a block.

    python3 kernel_sections.py
    python3 kernel_sections.py --kmax
    python3 kernel_sections.py --cla

Writes instrumented copies of ``emo_disentanger_tpu_torch/csrc/favor_fwd.cu``
and ``favor_bwd.cu`` to ``build/sections/`` (with the headers beside
them): in the bf16 instantiation of the forward and of each backward pass,
thread 0 of each block reads ``clock64()`` after every ``__syncthreads()``
of the chunk loop and after each call that ends with one (``row_sq_tc``,
``features*``, ``chain_rule*``), and adds the cycles since its last
reading to that section's count.  Every added statement is guarded by the
kernel's ``TC`` flag, so the f32 instantiations compile as before.  It
builds the copies and runs, at the bf16 train step's shape (B=16, 8 heads,
L=3072, Dh = 64, M = 128) in both layouts, the forward (#2 ``favor_fwd``,
#9 ``favor_fwd_hl``), pass A (#3, #10) and pass B (#4, #11, on pass A's
(u, w)), and prints, for each, one launch's time (CUDA events) and each
section's mean cycles a chunk with the source line that ends it.  A
section that waits at a barrier counts the wait for the slowest warp.
Last, it counts the opcodes of the bf16 kernels in the built libraries
(``cuobjdump -sass``: instructions in the code, not executed): the forward
in both layouts, each backward pass head-major.  The repository's own
sources are not touched.

``--kmax`` instead writes copies of ``favor_fwd.cu`` to
``build/sections/kmax<n>/`` in which the bf16 key max (#1 ``favor_kmax``,
#8 ``favor_kmax_hl``) takes n = 1, 2, 4 or 8 chunks a block whatever the
launch's size (``launch_kmax``'s rule replaced), and one more,
``kmax8s``, with 8 a block and omega read from shared memory instead of
registers (``kmax_omega_in_registers`` false); builds the five at once,
prints ptxas's registers for the bf16 key max, checks that all five give
the same partial maxima bit for bit, and times each (CUDA events) in
turns (1, 2, 4, 8, 8s, 8s, 8, 4, 2, 1) at B=16 L=3072 in both layouts,
B=16 L=2048 and B=2 L=1024.

``--cla`` does the same for the composed op's kernels in
``linear_attn.cu``, the forward #5 ``cla_fwd`` and the backward passes #6
``cla_bwd_a`` and #7 ``cla_bwd_b`` (every added statement runs
unconditionally, in each of the forward's dtype instantiations too): it
builds the copy and runs the three at the composed path's shape (BH=128,
L=3072, M=128, Dv=64, f32; pass B on pass A's (u, w)), prints each
section's cycles a chunk, then the kernels' SASS opcode counts (the
forward's f32 instantiation); last, it builds copies of the source whose
three kernels run 8, 16 or 24 warps a block (``CLA_THREADS``), checks
that they give the same outputs bit for bit, and times them in turns.
"""

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / 'emo_disentanger_tpu_torch' / 'csrc'
OUT = ROOT / 'build' / 'sections'
SLOTS = 32                        # sections counted at most, a kernel
ROWS = 4096                       # blocks (batch*head rows) counted at most
ENDS = re.compile(r'^(__syncthreads\(\);|row_sq_tc\(|features(_tc)?<|chain_rule(_tc)?[<(])')
IN_ORDER = 'for (int r0 = 0; r0 < L; r0 += C) {'
REVERSE = 'for (int r0 = ((L - 1) / C) * C; r0 >= 0; r0 -= C) {'
# each source: its instrumented kernels, each with the header of its chunk loop
KERNELS = {'favor_fwd.cu': {'favor_fwd': ('favor_fwd_kernel', IN_ORDER)},
           'favor_bwd.cu': {'favor_bwd_a': ('favor_bwd_a_kernel', IN_ORDER),
                            'favor_bwd_b': ('favor_bwd_b_kernel', REVERSE)},
           'linear_attn.cu': {'cla_fwd': ('cla_fwd_kernel', IN_ORDER),
                              'cla_bwd_a': ('cla_bwd_a_kernel', IN_ORDER),
                              'cla_bwd_b': ('cla_bwd_b_kernel', REVERSE)}}
# the condition each added statement runs under: the FAVOR+ kernels' bf16
# (tensor-core) instantiation; the composed op's kernels, all of them
GUARD = {'favor_fwd.cu': 'TC', 'favor_bwd.cu': 'TC', 'linear_attn.cu': 'true'}


def instrument_kernel(src, source, p, kernel, loop):
    """``src`` with kernel ``p`` of ``source`` stamped, and the line that
    ends each of its sections."""
    guard = GUARD[source]
    k0 = src.index(f'__global__ void {kernel}')
    k1 = src.index('\n}\n', k0) + 3                 # the kernel's closing brace
    first = src[:k0].count('\n') + 1                # the line k0 is on
    out, ends, in_loop, note = [], [], False, ''
    for line_no, line in enumerate(src[k0:k1].split('\n'), first):
        if loop in line:
            out.append(f'  unsigned long long sec_[{SLOTS}] = {{}}, '
                       f'last_ = {guard} ? clock64() : 0;')
            in_loop = True
        out.append(line)
        if line.strip().startswith('//'):
            note = line.strip()[3:]
        if in_loop and ENDS.match(line.strip()) and len(ends) < SLOTS:
            out.append(f'    if ({guard} && threadIdx.x == 0) {{ const unsigned long long c_ = '
                       f'clock64(); sec_[{len(ends)}] += c_ - last_; last_ = c_; }}')
            ends.append(f'{source}:{line_no} {line.strip()[:24]} (after "{note[:40]}")')
    body = '\n'.join(out)
    tail = body.rindex('  }\n}\n')
    body = (body[:tail] + f'  }}\n  if ({guard} && threadIdx.x == 0) for (int i = 0; i < {SLOTS}; '
            f'++i) g_sections[{p}][blockIdx.x][i] = sec_[i];\n}}\n' + body[tail + 6:])
    return src[:k0] + body + src[k1:], ends


def instrument(source='favor_bwd.cu'):
    """The instrumented copy of ``source`` and, for each of its kernels,
    the line that ends each of its sections."""
    src = (CSRC / source).read_text()
    kernels = KERNELS[source]
    ends = {}
    # the last kernel in the file first, so the lines of the others stay
    for p, (name, (kernel, loop)) in sorted(
            enumerate(kernels.items()), key=lambda e: -src.index(e[1][1][0])):
        src, ends[name] = instrument_kernel(src, source, p, kernel, loop)
    src = src.replace('#include "favor_common.cuh"\n', '#include "favor_common.cuh"\n'
                      f'__device__ unsigned long long g_sections[{len(kernels)}][{ROWS}]'
                      f'[{SLOTS}];\n', 1)
    src = src.replace('extern "C" {\n', 'extern "C" {\nint read_sections(void* dst) {\n'
                      '  return (int)cudaMemcpyFromSymbol(dst, g_sections, sizeof(g_sections));\n}\n',
                      1)
    return src, ends


# the composed op's threads a block, CLA_THREADS in linear_attn.cu, and
# the warps a block of the --cla copies timed against each other
CLA_THREADS = 'constexpr int CLA_THREADS = 512;'
CLA_WARPS = (8, 16, 24)
# the f32 instantiation of each --cla kernel in its mangled name
CLA_F32 = {'cla_fwd': 'cla_fwd_kernelIfff', 'cla_bwd_a': 'cla_bwd_a_kernel',
           'cla_bwd_b': 'cla_bwd_b_kernel'}


def cla_variant(warps):
    """``linear_attn.cu`` with its three kernels at ``warps`` a block."""
    src = (CSRC / 'linear_attn.cu').read_text()
    if src.count(CLA_THREADS) != 1:
        raise RuntimeError("CLA_THREADS is not in linear_attn.cu as expected")
    return src.replace(CLA_THREADS, f'constexpr int CLA_THREADS = {32 * warps};')


KMAX_RULE = 'while (TC && per < 8 && BH * nch / (2 * per) >= 512) per *= 2;'
KMAX_REGS = 'return Dh <= 8 * KMAX_STEPS && M <= 16 * (THREADS / 32);'
# (name, chunks a block, omega in registers where the widths allow)
KMAX_VARIANTS = (('1', 1, True), ('2', 2, True), ('4', 4, True), ('8', 8, True),
                 ('8s', 8, False))


def kmax_variant(per, regs=True):
    """``favor_fwd.cu`` with the bf16 key max's chunks a block fixed at
    ``per``, in place of ``launch_kmax``'s rule, and without ``regs``
    omega read from shared memory at every width."""
    src = (CSRC / 'favor_fwd.cu').read_text()
    if src.count(KMAX_RULE) != 1 or src.count(KMAX_REGS) != 1:
        raise RuntimeError("the key max's rules are not in favor_fwd.cu as expected")
    src = src.replace(KMAX_RULE, f'if (TC) per = {per};')
    return src if regs else src.replace(KMAX_REGS, 'return false;')


def build_variants(source, texts, load):
    """Build each copy of ``source`` in ``texts`` ({name: source text})
    under OUT/<name>/ at once; returns {name: (library, nvcc's output)},
    each library loaded by ``load()`` with ``_build`` pointed at it."""
    from emo_disentanger_tpu_torch.ops import _build
    stem, jobs, libs = source[:-len('.cu')], {}, {}
    for name, text in texts.items():
        _build.CSRC = OUT / name
        _build.BUILD_DIR = _build.CSRC / 'kernels'
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        (_build.CSRC / source).write_text(text)
        for header in CSRC.glob('*.cuh'):
            shutil.copy(header, _build.CSRC / header.name)
        target = _build._target(stem)
        jobs[name] = (_build.CSRC, target, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(target), str(_build.CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (csrc, target, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'{name}: nvcc exited {proc.returncode}\n{text}')
        _build.CSRC, _build.BUILD_DIR = csrc, target.parent
        _build._libs.pop(stem, None)
        libs[name] = (load(), text)
    return libs


def ptxas_lines(text, needle):
    """ptxas's lines for the kernels whose mangled names hold ``needle``."""
    entry, out = '', []
    for line in text.splitlines():
        if 'Compiling entry function' in line:
            entry = line
        elif needle in entry:
            out.append(line.strip())
    return out


def time_kmax_variants(smi):
    """Build the ``kmax_variant`` copies at once, then check and time each
    in turns at the main path's shapes (the docstring's ``--kmax``)."""
    from emo_disentanger_tpu_torch.ops import _build
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    built = build_variants('favor_fwd.cu', {f'kmax{name}': kmax_variant(per, regs)
                                            for name, per, regs in KMAX_VARIANTS}, la._lib)
    libs = {}
    for name, _, _ in KMAX_VARIANTS:
        libs[name], text = built[f'kmax{name}']
        for line in ptxas_lines(text, 'favor_kmax_kernelI13__nv_bfloat16'):
            if name in ('1', '8s'):
                print(f'kernel_sections --kmax {name} ptxas: ' + line)
    dev, H = torch.device('cuda'), 8
    gen = torch.Generator().manual_seed(0)
    omega = la.draw_orthogonal_features(64, 128, gen).to(dev)
    for layout, B, L in (('head-major', 16, 3072), ('heads-last', 16, 3072),
                         ('head-major', 16, 2048), ('head-major', 2, 1024)):
        k = (0.5 * torch.randn(B * H, L, 64, generator=gen)).to(dev, torch.bfloat16)
        if layout == 'heads-last':
            k = la._merge_heads(k, B)
            run = lambda: la._favor_kmax_hl_cuda(k, omega, H)
        else:
            run = lambda: la._favor_kmax_cuda(k, omega)
        parts, ms = {}, {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            _build._libs['favor_fwd'] = libs[name]
            parts[name] = run()
            ms[name].append(mean_ms(run, 50, 3))
        same = all(torch.equal(part, parts['1']) for part in parts.values())
        print(f'kernel_sections --kmax bf16 {layout} B={B} H={H} L={L} [{smi}]: '
              + ', '.join(f'{name} a block {t[0]:.4f} / {t[1]:.4f} ms'
                          for name, t in ms.items())
              + f'; partial maxima {"bitwise equal" if same else "DIFFER"} across them')
        if not same:
            raise RuntimeError('the key max depends on its chunks a block')


def mean_ms(run, iters, warmup):
    """Mean ms of one launch from CUDA events over ``iters``."""
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        run()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def time_launch(run):
    """ms of one launch (CUDA events over 10), then one more launch whose
    section counts stay in g_sections."""
    ms = mean_ms(run, 10, 1)
    run()
    torch.cuda.synchronize()
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--kmax', action='store_true',
                    help='time the bf16 key max at 1, 2, 4 and 8 chunks a block')
    ap.add_argument('--cla', action='store_true',
                    help="the composed op's forward and backward passes (linear_attn.cu)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('kernel_sections: CUDA is not available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    smi = os.popen('nvidia-smi --query-gpu=name,power.limit --format=csv,noheader').read().strip()
    if args.kmax:
        time_kmax_variants(smi)
        return 0
    from emo_disentanger_tpu_torch.ops import _build
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    sources = ('linear_attn.cu',) if args.cla else ('favor_fwd.cu', 'favor_bwd.cu')
    ends = build_instrumented(sources)
    if args.cla:
        time_cla_sections(ends['linear_attn.cu'], smi)
        return 0
    dev, H, B, L = torch.device('cuda'), 8, 16, 3072
    gen = torch.Generator().manual_seed(0)
    omega = la.draw_orthogonal_features(64, 128, gen).to(dev)
    chunks = -(-L // la.KERNEL_CHUNK)
    for layout in ('head-major', 'heads-last'):
        q, k, v, g = [(0.5 * torch.randn(B * H, L, 64, generator=gen)).to(dev, torch.bfloat16)
                      for _ in range(4)]
        if layout == 'heads-last':
            q, k, v, g = (la._merge_heads(t, B) for t in (q, k, v, g))
            part = la._favor_kmax_hl_cuda(k, omega, H)
            _, u, w = la._favor_bwd_a_hl_cuda(q, k, v, g, omega, part, H)
            runs = {'favor_fwd': lambda: la._favor_fwd_hl_cuda(q, k, v, omega, part, H),
                    'favor_bwd_a': lambda: la._favor_bwd_a_hl_cuda(q, k, v, g, omega, part, H),
                    'favor_bwd_b': lambda: la._favor_bwd_b_hl_cuda(q, k, v, u, w, omega, part,
                                                                   H)}
        else:
            part = la._favor_kmax_cuda(k, omega)
            _, u, w = la._favor_bwd_a_cuda(q, k, v, g, omega, part)
            runs = {'favor_fwd': lambda: la._favor_fwd_cuda(q, k, v, omega, part),
                    'favor_bwd_a': lambda: la._favor_bwd_a_cuda(q, k, v, g, omega, part),
                    'favor_bwd_b': lambda: la._favor_bwd_b_cuda(q, k, v, u, w, omega, part)}
        for name, run in runs.items():
            source = next(src for src, names in KERNELS.items() if name in names)
            ms = time_launch(run)
            per = read_cycles(source, name, B * H, chunks)
            print_sections(f'{name} {layout} bf16 B={B} H={H} L={L} [{smi}]', ms, per,
                           ends[source][name])
    for hl in (False, True):
        print_sass(_build._target('favor_fwd'), 'favor_fwd_kernel', hl=hl)
    for kernel, _ in KERNELS['favor_bwd.cu'].values():
        print_sass(_build._target('favor_bwd'), kernel)
    return 0


def build_instrumented(sources):
    """Write the instrumented copies of ``sources`` (with the headers) to
    OUT, point ``_build`` at them and build them; returns each source's
    section ends."""
    from emo_disentanger_tpu_torch.ops import _build
    OUT.mkdir(parents=True, exist_ok=True)
    ends = {}
    for source in sources:
        src, ends[source] = instrument(source)
        (OUT / source).write_text(src)
    for header in CSRC.glob('*.cuh'):
        shutil.copy(header, OUT / header.name)
    _build.CSRC, _build.BUILD_DIR = OUT, OUT / 'kernels'
    _build.build([source[:-len('.cu')] for source in sources])
    return ends


def print_sections(label, ms, per, ends):
    """One launch's time and each section's mean cycles a chunk."""
    total = per.sum()
    print(f'kernel_sections {label}: {ms:.4f} ms a launch (CUDA events, instrumented); '
          f'{total:.0f} cycles a chunk')
    for i, end in enumerate(ends):
        if per[i]:
            print(f'  {per[i]:9.0f} cycles ({per[i] / total:6.1%}) to {end[:60]}')


def read_cycles(source, name, rows, chunks):
    """Kernel ``name``'s mean cycles a chunk by section over ``rows``."""
    from emo_disentanger_tpu_torch.ops import _build
    kernels = list(KERNELS[source])
    buf = (ctypes.c_ulonglong * (len(kernels) * ROWS * SLOTS))()
    err = _build._libs[source[:-len('.cu')]].read_sections(buf)
    if err:
        raise RuntimeError(f'read_sections: CUDA error {err}')
    cyc = np.frombuffer(buf, dtype=np.uint64).reshape(len(kernels), ROWS, SLOTS)
    return cyc[kernels.index(name), :rows].astype(np.float64).mean(0) / chunks


def time_cla_sections(ends, smi):
    """The ``--cla`` run: the forward and both passes of the instrumented
    linear_attn.cu at the composed path's shape, then their SASS, then the
    copies at each warps a block."""
    from emo_disentanger_tpu_torch.ops import _build
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    dev, BH, L, M, Dv = torch.device('cuda'), 128, 3072, 128, 64
    gen = torch.Generator().manual_seed(0)
    omega = la.draw_orthogonal_features(64, M, gen).to(dev)
    x = lambda D: (0.5 * torch.randn(BH, L, D, generator=gen)).to(dev)
    q = la.favor_features(x(64), omega, is_query=True)
    k = la.favor_features(x(64), omega, is_query=False)
    v, g = x(Dv), x(Dv)
    _, u, w_in = la._cla_bwd_a_cuda(q, k, v, g)
    runs = {'cla_fwd': lambda: la._cla_fwd_cuda(q, k, v),
            'cla_bwd_a': lambda: la._cla_bwd_a_cuda(q, k, v, g),
            'cla_bwd_b': lambda: la._cla_bwd_b_cuda(q, k, v, u, w_in)}
    for name, run in runs.items():
        ms = time_launch(run)
        per = read_cycles('linear_attn.cu', name, BH, -(-L // la.KERNEL_CHUNK))
        print_sections(f'{name} f32 BH={BH} L={L} M={M} Dv={Dv} [{smi}]', ms, per,
                       ends[name])
    for name, (kernel, _) in KERNELS['linear_attn.cu'].items():
        print_sass(_build._target('linear_attn'), kernel, CLA_F32[name], 'f32')

    # the three kernels at 8, 16 and 24 warps a block, checked bitwise, in turns
    built = build_variants('linear_attn.cu', {f'cla{w}': cla_variant(w) for w in CLA_WARPS},
                           la._cla_lib)
    outs, ms = {}, {w: {name: [] for name in runs} for w in CLA_WARPS}
    for w in CLA_WARPS + CLA_WARPS[::-1]:
        lib, text = built[f'cla{w}']
        _build._libs['linear_attn'] = lib
        if w not in outs:
            print(f'kernel_sections --cla {w} warps ptxas: ' + ' | '.join(
                f'{name} {line}' for name, needle in CLA_F32.items()
                for line in ptxas_lines(text, needle) if 'registers' in line))
            outs[w] = ((la._cla_fwd_cuda(q, k, v),) + la._cla_bwd_a_cuda(q, k, v, g)
                       + la._cla_bwd_b_cuda(q, k, v, u, w_in))
        for name, run in runs.items():
            ms[w][name].append(mean_ms(run, 20, 3))
    same = all(torch.equal(a, b) for w in CLA_WARPS for a, b in zip(outs[w], outs[CLA_WARPS[0]]))
    print(f'kernel_sections --cla f32 BH={BH} L={L} M={M} Dv={Dv} in turns [{smi}]: '
          + ', '.join(f'{w} warps {name} {t[0]:.4f} / {t[1]:.4f} ms'
                      for w in CLA_WARPS for name, t in ms[w].items())
          + f'; outputs {"bitwise equal" if same else "DIFFER"} across them')
    if not same:
        raise RuntimeError("the composed op's kernels depend on their warps a block")


def print_sass(lib, kernel, needle=None, label=None, hl=False):
    """The opcodes of the kernel whose mangled name holds ``needle`` (by
    default the bf16 instantiation of ``kernel``, heads-last with ``hl``,
    else head-major), most frequent first."""
    needle = needle or f'{kernel}I13__nv_bfloat16Lb{int(hl)}'
    label = label or f'bf16, {"heads-last" if hl else "head-major"}'
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    text = subprocess.run([tool, '-sass', str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, inside = Counter(), False
    for line in text.splitlines():
        if 'Function :' in line:
            inside = needle in line
        elif inside:
            op = re.search(r'\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)', line)
            if op:
                counts[op.group(1)] += 1
    print(f'kernel_sections SASS of {kernel}<{label}>: '
          + ', '.join(f'{op} {n}' for op, n in counts.most_common(16)))


if __name__ == '__main__':
    sys.exit(main())
