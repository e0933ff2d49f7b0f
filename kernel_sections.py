#!/usr/bin/env python3
"""Where FAVOR+ backward pass A's and pass B's time goes inside a chunk, on
the GPU.

    python3 kernel_sections.py

Writes an instrumented copy of ``emo_disentanger_tpu_torch/csrc/favor_bwd.cu``
to ``build/sections/``: in each pass's bf16 instantiation, thread 0 of each
block reads ``clock64()`` after every ``__syncthreads()`` of the chunk loop
and after each call that ends with one (``row_sq_tc``, ``features*``,
``chain_rule*``), and adds the cycles since its last reading to that
section's count.  Every added statement is guarded by the kernel's ``TC``
flag, so the f32 instantiations compile as before.  It builds the copy
(with ``favor_fwd.cu`` for the key maxima), runs pass A and then pass B (on
pass A's (u, w)) at the bf16 train step's shape (B=16, 8 heads, L=3072,
Dh = 64, M = 128) in both layouts (#3 ``favor_bwd_a``, #4 ``favor_bwd_b``,
#10 ``favor_bwd_a_hl``, #11 ``favor_bwd_b_hl``), and prints, for each, one
launch's time (CUDA events) and each section's mean cycles a chunk with the
source line that ends it.  A section that waits at a barrier counts the
wait for the slowest warp.  Last, it counts the opcodes of the head-major
bf16 kernel of each pass in the built library (``cuobjdump -sass``:
instructions in the code, not executed).  The repository's own sources are
not touched.
"""

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
SLOTS = 32                        # sections counted at most, a pass
ROWS = 4096                       # blocks (batch*head rows) counted at most
ENDS = re.compile(r'^(__syncthreads\(\);|row_sq_tc\(|features(_tc)?<|chain_rule(_tc)?[<(])')
# each pass: its kernel and the header of its chunk loop
PASSES = {'favor_bwd_a': ('favor_bwd_a_kernel', 'for (int r0 = 0; r0 < L; r0 += C) {'),
          'favor_bwd_b': ('favor_bwd_b_kernel',
                          'for (int r0 = ((L - 1) / C) * C; r0 >= 0; r0 -= C) {')}


def instrument_kernel(src, p, kernel, loop):
    """``src`` with pass ``p``'s kernel stamped, and the line that ends each
    of its sections."""
    k0 = src.index(f'__global__ void {kernel}')
    k1 = src.index('\ntemplate <', k0) + 1          # the next template: the kernel's end
    first = src[:k0].count('\n') + 1                # the line k0 is on
    out, ends, in_loop, note = [], [], False, ''
    for line_no, line in enumerate(src[k0:k1].split('\n'), first):
        if loop in line:
            out.append(f'  unsigned long long sec_[{SLOTS}] = {{}}, last_ = TC ? clock64() : 0;')
            in_loop = True
        out.append(line)
        if line.strip().startswith('//'):
            note = line.strip()[3:]
        if in_loop and ENDS.match(line.strip()) and len(ends) < SLOTS:
            out.append(f'    if (TC && threadIdx.x == 0) {{ const unsigned long long c_ = '
                       f'clock64(); sec_[{len(ends)}] += c_ - last_; last_ = c_; }}')
            ends.append(f'favor_bwd.cu:{line_no} {line.strip()[:24]} (after "{note[:40]}")')
    body = '\n'.join(out)
    tail = body.rindex('  }\n}\n')
    body = (body[:tail] + f'  }}\n  if (TC && threadIdx.x == 0) for (int i = 0; i < {SLOTS}; '
            f'++i) g_sections[{p}][blockIdx.x][i] = sec_[i];\n}}\n' + body[tail + 6:])
    return src[:k0] + body + src[k1:], ends


def instrument():
    """The instrumented source and, for each pass, the line that ends each
    of its sections."""
    src = (CSRC / 'favor_bwd.cu').read_text()
    ends = {}
    # the last kernel in the file first, so the lines of the others stay
    for p, (name, (kernel, loop)) in sorted(
            enumerate(PASSES.items()), key=lambda e: -src.index(e[1][1][0])):
        src, ends[name] = instrument_kernel(src, p, kernel, loop)
    src = src.replace('#include "favor_common.cuh"\n', '#include "favor_common.cuh"\n'
                      f'__device__ unsigned long long g_sections[{len(PASSES)}][{ROWS}]'
                      f'[{SLOTS}];\n', 1)
    src = src.replace('extern "C" {\n', 'extern "C" {\nint read_sections(void* dst) {\n'
                      '  return (int)cudaMemcpyFromSymbol(dst, g_sections, sizeof(g_sections));\n}\n',
                      1)
    return src, ends


def time_launch(run):
    """ms of one launch (CUDA events over 10), then one more launch whose
    section counts stay in g_sections."""
    run()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        run()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / 10
    run()
    torch.cuda.synchronize()
    return ms


def main():
    if not torch.cuda.is_available():
        print('kernel_sections: CUDA is not available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from emo_disentanger_tpu_torch.ops import _build
    from emo_disentanger_tpu_torch.ops import linear_attention as la
    OUT.mkdir(parents=True, exist_ok=True)
    src, ends = instrument()
    (OUT / 'favor_bwd.cu').write_text(src)
    for name in ('favor_fwd.cu', *(p.name for p in CSRC.glob('*.cuh'))):
        shutil.copy(CSRC / name, OUT / name)
    _build.CSRC, _build.BUILD_DIR = OUT, OUT / 'kernels'
    _build.build(['favor_fwd', 'favor_bwd'])
    dev, H, B, L = torch.device('cuda'), 8, 16, 3072
    gen = torch.Generator().manual_seed(0)
    omega = la.draw_orthogonal_features(64, 128, gen).to(dev)
    chunks = -(-L // la.KERNEL_CHUNK)
    smi = os.popen('nvidia-smi --query-gpu=name,power.limit --format=csv,noheader').read().strip()
    for layout in ('head-major', 'heads-last'):
        q, k, v, g = [(0.5 * torch.randn(B * H, L, 64, generator=gen)).to(dev, torch.bfloat16)
                      for _ in range(4)]
        if layout == 'heads-last':
            q, k, v, g = (la._merge_heads(t, B) for t in (q, k, v, g))
            part = la._favor_kmax_hl_cuda(k, omega, H)
            _, u, w = la._favor_bwd_a_hl_cuda(q, k, v, g, omega, part, H)
            runs = {'favor_bwd_a': lambda: la._favor_bwd_a_hl_cuda(q, k, v, g, omega, part, H),
                    'favor_bwd_b': lambda: la._favor_bwd_b_hl_cuda(q, k, v, u, w, omega, part,
                                                                   H)}
        else:
            part = la._favor_kmax_cuda(k, omega)
            _, u, w = la._favor_bwd_a_cuda(q, k, v, g, omega, part)
            runs = {'favor_bwd_a': lambda: la._favor_bwd_a_cuda(q, k, v, g, omega, part),
                    'favor_bwd_b': lambda: la._favor_bwd_b_cuda(q, k, v, u, w, omega, part)}
        for p, (name, run) in enumerate(runs.items()):
            ms = time_launch(run)
            buf = (ctypes.c_ulonglong * (len(PASSES) * ROWS * SLOTS))()
            err = _build._libs['favor_bwd'].read_sections(buf)
            if err:
                raise RuntimeError(f'read_sections: CUDA error {err}')
            cyc = np.frombuffer(buf, dtype=np.uint64).reshape(len(PASSES), ROWS, SLOTS)
            per = cyc[p, :B * H].astype(np.float64).mean(0) / chunks
            total = per.sum()
            print(f'kernel_sections {name} {layout} bf16 B={B} H={H} L={L} [{smi}]: '
                  f'{ms:.4f} ms a launch (CUDA events, instrumented); {total:.0f} cycles '
                  f'a chunk')
            for i, end in enumerate(ends[name]):
                if per[i]:
                    print(f'  {per[i]:9.0f} cycles ({per[i] / total:6.1%}) to {end[:60]}')
    for kernel, _ in PASSES.values():
        print_sass(_build._target('favor_bwd'), kernel)
    return 0


def print_sass(lib, kernel):
    """The opcodes of the head-major bf16 instantiation of ``kernel``, most
    frequent first."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    text = subprocess.run([tool, '-sass', str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, inside = Counter(), False
    for line in text.splitlines():
        if 'Function :' in line:
            inside = f'{kernel}I13__nv_bfloat16Lb0' in line
        elif inside:
            op = re.search(r'\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)', line)
            if op:
                counts[op.group(1)] += 1
    print(f'kernel_sections SASS of {kernel}<bf16, head-major>: '
          + ', '.join(f'{op} {n}' for op, n in counts.most_common(16)))


if __name__ == '__main__':
    sys.exit(main())
