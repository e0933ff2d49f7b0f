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
  while recording.

There is no switch: an operator traces the program by running it under a
profiler (:func:`trace`, or any ``torch.profiler.profile``).  Span names
start with ``emodis.``; counter names with their layer's name:

==========================  ==================================================
``emodis.serve.step``       one decode step of ``Stage2BatchGenerator``
``emodis.serve.sample``     its nucleus sampler
``emodis.serve.refill``     ``serve``'s work between two chunks: the status
                            read, the harvest of finished songs, the re-arm
``emodis.data.batch``       ``Stage2Dataset.batches`` building one batch
``serve.steps``             decode steps taken while recording
``serve.slot_steps``        running slots, summed over those steps
``serve.live_rows``         GPT-2: each running slot's clock at the step's
                            start, summed over those steps (a step attends
                            to clock + 1 cache rows)
==========================  ==================================================

The serve counters are exact: the steps accumulate on the device and reach
``COUNTS`` through the generator's next status read (``_poll``), so the
three count the same steps even when the profiler stops between reads.
"""

from __future__ import annotations

import collections
import contextlib

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
