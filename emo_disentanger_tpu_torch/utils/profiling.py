"""Tracing (port of ``emo_disentanger_tpu/utils/profiling.py``'s ``trace``)
and the program's own spans and counters.

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  trace TensorBoard reads (``torch.profiler.tensorboard_trace_handler``);
* :func:`recording`: whether a ``torch.profiler`` is recording now (false
  outside a profiler and in a schedule's wait and warm-up steps);
* :func:`span`: a named host range while recording
  (``torch.profiler.record_function``), else a shared no-op.  A span is one
  of the profiler's own host ranges, so it sits on the clock of the device
  activities in the same trace;
* :data:`COUNTS` and :func:`count`: plain host integers, added to only
  while recording;
* :func:`accumulate` and :func:`flush`: a decode loop's serve counters,
  added up on the device a step and moved to ``COUNTS`` by the loop's one
  host read of its status flags.

There is no switch: an operator traces the program by running it under a
profiler (:func:`trace`, or any ``torch.profiler.profile``).  Span names
start with ``emodis.``; counter names with their layer's name:

==========================  ==================================================
``emodis.serve.step``       one decode step of either stage's generator
                            (``infer.slots.SlotLoop._step``)
``emodis.serve.sample``     its nucleus sampler
``emodis.serve.refill``     ``serve`` between two chunks
                            (``infer.slots``): the read, the harvest of
                            finished songs, the re-arm
``emodis.txl.attn``         one Transformer-XL layer's cache work in a decode
                            step: the k and v row writes and the
                            relative-position attention
                            (``TXLSelfAttention.decode_step``,
                            ``decode_step_pe``)
``emodis.data.batch``       ``Stage2Dataset.batches`` building one batch
``serve.steps``             decode steps taken while recording
``serve.slot_steps``        running slots, summed over those steps
``serve.live_rows``         GPT-2 and stage 1: each running slot's clock at
                            the step's start, summed over those steps (a
                            step attends to clock + 1 cache rows)
==========================  ==================================================

The serve counters are exact: the steps accumulate on the device
(:func:`accumulate`) and reach ``COUNTS`` through the generator's next
status read (:func:`flush` in ``infer.slots.SlotLoop._poll``), so the
three count the same steps even when the profiler stops between reads.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List

import torch

COUNTS: collections.Counter = collections.Counter()

_NO_SPAN = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler is recording (about 0.1-0.2 us on a CPU host)."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """``with span('emodis.x'):`` a host range named ``name`` while
    recording; otherwise one shared no-op, nothing allocated.  A
    ``record_function`` costs some 13 us even when no profiler runs, so the
    check comes first."""
    if recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[name]`` while recording."""
    if recording():
        COUNTS[name] += n


SERVE_COUNTS = ('serve.slot_steps', 'serve.live_rows')


def accumulate(s: Dict, n: torch.Tensor) -> None:
    """Add one step's counts ``n`` (a device vector: the running slots,
    and where the model has a cache the sum of their clocks, as
    ``SERVE_COUNTS`` orders them) to the loop state's ``s['counted']``, and
    the step to ``s['counted_steps']``, for :func:`flush`."""
    s['counted'] = s['counted'] + n if 'counted' in s else n
    s['counted_steps'] = s.get('counted_steps', 0) + 1


def flush(s: Dict, flags: torch.Tensor) -> List:
    """Read ``flags`` (a device vector) to the host, and with it in the
    same ``.tolist()`` the counts accumulated since the last flush, which
    are added to ``COUNTS``; returns the flags' values."""
    counted = s.pop('counted', None)
    if counted is None:
        return flags.tolist()
    got = torch.cat([flags, counted]).tolist()
    COUNTS['serve.steps'] += s.pop('counted_steps')
    for name, n in zip(SERVE_COUNTS, got[len(flags):]):
        COUNTS[name] += n
    return got[:len(flags)]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host and device trace: ``with trace('tb'): step()``.  The
    device's activities are traced where CUDA is present; the program's
    spans appear among the host ranges."""
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
