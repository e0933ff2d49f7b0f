"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
by ``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the root of
the checkout, then loaded with ``ctypes``.  A library's file name carries a
hash of its source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and a stale build is never loaded.
``build()`` starts one ``nvcc`` per source at once and waits for all of
them.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a non-zero code.  ``LAUNCHES`` counts, per kernel
name, the launches the wrappers made; wrappers add one where they launch
and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / 'build' / 'kernels'
SOURCES = ('favor_fwd', 'favor_bwd', 'performer_decode', 'flash_attn_fwd',
           'linear_attn', 'txl_decode_attn')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

LAUNCHES: collections.Counter = collections.Counter()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found (needed to build the CUDA kernels '
                           'under emo_disentanger_tpu_torch/csrc)')
    return path


def _target(name: str) -> Path:
    text = [(CSRC / f'{name}.cu').read_bytes()]
    text += [h.read_bytes() for h in sorted(CSRC.glob('*.cuh'))]
    digest = hashlib.sha256(b''.join(text)
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source that has no current build, all in
    parallel.  ``nvcc``'s output (with ``-Xptxas=-v``: registers, shared
    memory and spills per kernel) is kept beside each library as ``.log``.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    errors = []
    for name, proc, tmp, out in jobs:
        text, _ = proc.communicate()
        out.with_suffix('.log').write_text(text)
        if proc.returncode:
            errors.append(f'{name}: nvcc exited {proc.returncode}\n{text}')
        else:
            os.replace(tmp, out)        # atomic: concurrent builds agree
    if errors:
        raise RuntimeError('\n'.join(errors))


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    point returns an ``int`` CUDA error code."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        lib.emodis_error_string.argtypes = [ctypes.c_int]
        lib.emodis_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        msg = lib.emodis_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
