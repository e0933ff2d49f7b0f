"""Tracing and throughput utilities (port of
``emo_disentanger_tpu/utils/profiling.py``).

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  trace TensorBoard reads (``torch.profiler.tensorboard_trace_handler``);
* :class:`Throughput`: tokens/s and tokens/s a chip for train and decode
  loops;
* :class:`step_timer`: per-step wall times on the host clock, summarized
  with percentiles.  On CUDA the host clock runs ahead of the device, so
  the caller synchronizes inside the timed block; the training drivers do
  it by reading the step's loss.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host and device trace: ``with trace('tb'): step()``.  The
    device's activities are traced where CUDA is present."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


class Throughput:
    """Sliding tokens/sec counter.  ``n_chips`` defaults to the world size,
    or 1 without a process group."""

    def __init__(self, n_chips: Optional[int] = None):
        if n_chips is None:
            n_chips = dist.get_world_size() if dist.is_initialized() else 1
        self.n_chips = n_chips
        self.reset()

    def reset(self):
        self._tokens = 0
        self._t0 = time.perf_counter()

    def add(self, n_tokens: int):
        self._tokens += int(n_tokens)

    @property
    def tokens_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._tokens / dt if dt > 0 else 0.0

    @property
    def tokens_per_sec_per_chip(self) -> float:
        return self.tokens_per_sec / max(self.n_chips, 1)

    def report(self) -> Dict[str, float]:
        tps = self.tokens_per_sec            # snapshot once: dt keeps moving
        return {
            'tokens': self._tokens,
            'tokens_per_sec': tps,
            'tokens_per_sec_per_chip': tps / max(self.n_chips, 1),
        }


class step_timer:
    """Collect per-step wall times; summarize with percentiles.  On CUDA
    the caller synchronizes before the block ends (module docstring)."""

    def __init__(self):
        self.times: List[float] = []
        self._t = None

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t)
        return False

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {
            'n': len(a),
            'mean_s': float(a.mean()),
            'p50_s': float(np.percentile(a, 50)),
            'p95_s': float(np.percentile(a, 95)),
            'max_s': float(a.max()),
        }
