"""The traced run's reading of ``torch.profiler``: the device timeline of a
fixed number of steps, reduced to what the per-layer metrics read.

A ``Trace`` records ``steps`` steps after ``skip`` steps (the driver calls
``step()`` once a step), so the traced window holds whole steps of the
cell's own shapes.  From it: ``window_s``, the span from the first to the
last event; ``busy_s``, the union of the intervals in which an operation
(kernel, copy, set) ran on the device; the device time by kernel name; the
device time under each host operator (``aten::einsum`` and what it
launched); and the idle gaps between device operations, named by the
innermost host range open at each gap's middle.
"""

from __future__ import annotations

import bisect
import collections
import sys
import time
from typing import Dict, List, Tuple

import torch


class Trace:
    def __init__(self, skip: int, steps: int):
        from torch.profiler import ProfilerActivity, profile, schedule
        self.skip, self.steps = skip, steps
        self.n = 0
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=max(skip - 1, 0), warmup=1, active=steps,
                              repeat=1))
        self.prof.__enter__()
        self._open = True

    def step(self) -> None:
        if self._open:
            self.n += 1
            self.prof.step()

    @property
    def complete(self) -> bool:
        """Whether every traced step has been taken."""
        return self.n > self.skip + self.steps

    def close(self) -> 'Reading':
        if self._open:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.prof.__exit__(None, None, None)
            self._open = False
            print(f'trace: stopped in {time.perf_counter() - t0:.1f} s',
                  file=sys.stderr)
        t0 = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        t1 = time.perf_counter()
        reading = Reading(events, self.steps)
        print(f'trace: {len(events)} events, taken in {t1 - t0:.1f} s, '
              f'read in {time.perf_counter() - t1:.1f} s', file=sys.stderr)
        return reading


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


class Reading:
    """What a traced window shows (times in seconds).  It reads the
    profiler's raw events, not the operator tree that ``prof.events()``
    builds, which takes several times as long (a generation step launches
    some 4,000 device operations)."""

    def __init__(self, events, steps: int):
        from torch.autograd import DeviceType
        self.steps = steps
        host, device, notes = [], [], set()
        for e in events:
            name = e.name()
            a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
            if e.device_type() == DeviceType.CPU:
                notes.add(name)
                host.append((a, b, name, e.correlation_id()))
            else:
                device.append((a, b, name, e.linked_correlation_id()))
        # times in microseconds: host (start, end, name, id), device
        # (start, end, name, id of the host operator that launched it); a
        # host range's device-side copy (a profiler step, a
        # ``record_function``: the same name) is no device work
        self.host = host
        self.device = [d for d in device if d[2] not in notes]
        spans = [(a, b) for a, b, *_ in host + device if b > a]
        self.merged = _union([(a, b) for a, b, *_ in self.device])
        self.window_s = ((max(b for _, b in spans) - min(a for a, _ in spans))
                         / 1e6 if spans else 0.0)
        self.busy_s = sum(b - a for a, b in self.merged) / 1e6
        self.by_kernel: Dict[str, float] = collections.Counter()
        for a, b, name, _ in self.device:
            self.by_kernel[name] += (b - a) / 1e6

    def kernel_seconds(self, needles) -> float:
        """Device seconds of the operations whose names hold any needle."""
        return sum(s for k, s in self.by_kernel.items()
                   if any(n in k for n in needles))

    def op_device_seconds(self, name: str) -> float:
        """Device seconds launched under the host operator ``name``: by
        operators that started inside one of its calls (itself or its
        children), each device operation counted once."""
        calls = _union([(a, b) for a, b, n, _ in self.host if n == name])
        if not calls:
            return 0.0
        starts = [a for a, _ in calls]
        launched = {}
        for a, _, n, cid in self.host:
            if not n.startswith('cu'):          # not a CUDA API call
                i = bisect.bisect_right(starts, a) - 1
                launched[cid] = i >= 0 and a <= calls[i][1]
        return sum(b - a for a, b, _, cid in self.device
                   if launched.get(cid)) / 1e6

    def breakdown(self, n_top: int = 10) -> dict:
        top = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])[:n_top]
        return {'device_ops': [[k[:120], v] for k, v in top],
                'idle_gaps': self.idle_gaps(n_top)}

    def idle_gaps(self, n_top: int = 10) -> List[list]:
        """Idle device time between operations, summed by what the host
        was doing at each gap's middle: its innermost open range, found in
        one sweep over the host ranges by start (a stack of the ranges
        open; the latest started that is still open is the innermost)."""
        hosts = sorted((h[:3] for h in self.host), key=lambda h: (h[0], -h[1]))
        by_name: Dict[str, float] = collections.Counter()
        stack: List[tuple] = []
        i = 0
        for (_, a1), (b0, _) in zip(self.merged, self.merged[1:]):
            mid = (a1 + b0) / 2
            while i < len(hosts) and hosts[i][0] <= mid:
                while stack and stack[-1][1] < hosts[i][0]:
                    stack.pop()
                stack.append(hosts[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else 'host outside any range'
            by_name[name] += (b0 - a1) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
        return [[k[:120], v] for k, v in top]

