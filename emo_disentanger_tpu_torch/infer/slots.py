"""The continuous-batching slot loop that both stages' generators share.

A generator built on :class:`SlotLoop` keeps B slots (this rank's ``nb`` of
them over a ``mesh``) in one state dict of device tensors, and its
``serve`` streams N jobs through them:

* the first min(B, N) jobs are armed in the first slots and the other slots
  set IDLE, in one re-arm;
* a chunk steps every slot (``_step``) and reads the host every
  ``HOST_CHECK_STEPS`` steps (``_poll``); it ends once a slot has finished
  and at least ``chunk_steps`` steps have passed, or once nothing runs.
  Slots that are not running keep stepping, frozen by the stage's status
  masks, so the extra steps change nothing;
* between two chunks one read gathers every slot's running flag and
  per-job fields, the finished slots are harvested, and one masked update
  (the stage's ``_rearm``) gives each the next queued job or sets it IDLE;
* the loop ends when no slot holds a job, which the host knows without a
  read.

The jobs' fields stay in host numpy arrays [N, ...]; ``_job_rows`` copies
the rows of the jobs being armed to the device at every re-arm.

Tracing (``utils.profiling``): while a profiler records, each step is the
span ``emodis.serve.step`` and adds its running slots (and, where the model
has a cache, their clocks) to a device accumulator, which ``_poll`` moves
to ``COUNTS`` through its one host read; the work between two chunks (the
read, the harvest, the re-arm) is the span ``emodis.serve.refill``.

Over a mesh whose data axes (dp * dcn) exceed one, each rank steps its own
rows; the poll's flags are reduced over the data axes and the refill
gathers every rank's rows, so every rank makes the same decision over all
B slots, applies it to its own rows, and returns the global results.

A stage supplies the step body (``_advance``), which slots run
(``_running``), its blank state (``_open``) and re-arm (``_rearm``), and
the host values its poll reads beside the flags (``_bounds``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..parallel.mesh import batch_rows, gather_rows, reduce_flags
from ..utils.device import resolve_device
from ..utils.profiling import flush, recording, span

# steps between host reads of the status; at most 32
HOST_CHECK_STEPS = 16


class SlotLoop:
    """B slots of one generator on one device, or this rank's rows of them
    over a ``mesh``'s data axes (module docstring)."""

    def __init__(self, model, *, batch: int, mesh=None,
                 device: Union[str, torch.device]):
        """``batch`` counts the slots over all ranks (it must divide by the
        mesh's dp * dcn); ``model`` must sit on ``device``."""
        self.device = resolve_device(device)
        self.mesh, self.rows = batch_rows(mesh, batch)
        self.nb = self.rows.stop - self.rows.start      # this rank's slots
        if model.device != self.device:
            raise ValueError(f'model on {model.device}; expected {self.device}')
        self.model = model
        self.batch = batch

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _step(self, s: Dict, gen: torch.Generator, **kw) -> None:
        """One decode step for every slot, updating ``s`` in place; while a
        profiler records, in the span ``emodis.serve.step`` and counted
        (the stage's ``_count_step``)."""
        counting = recording()
        with span('emodis.serve.step'):
            self._advance(s, gen, counting, **kw)

    def _bounds(self, s: Dict) -> Dict[str, torch.Tensor]:
        """Device scalars that ``_poll`` reads with its flags, reduced by
        max over the data axes and stored in ``s`` under their names."""
        return {}

    def _poll(self, s: Dict, entry: Optional[torch.Tensor] = None
              ) -> Tuple[bool, bool]:
        """One host read: (whether any slot is running, whether the running
        set differs from ``entry``), over every rank's rows, with the
        stage's ``_bounds``.  It also moves the steps counted since the last
        read into ``COUNTS`` (this rank's)."""
        run = self._running(s)
        changed = (run != entry).any() if entry is not None else run.any()
        bounds = self._bounds(s)
        flags = flush(s, torch.stack([run.any().long(), changed.long(),
                                      *bounds.values()]))
        any_run, changed, *values = reduce_flags(self.mesh, flags)
        s.update(zip(bounds, values))
        return bool(any_run), bool(changed)

    def _run_chunk(self, s: Dict, gen: torch.Generator, chunk_steps: int,
                   **kw) -> int:
        """Step until nothing runs, or a slot has finished and at least
        ``chunk_steps`` steps have passed (checked every HOST_CHECK_STEPS
        steps); returns the steps run.  ``kw`` goes to every ``_step``."""
        entry = self._running(s)
        i = 0
        while True:
            any_run, changed = self._poll(s, entry)
            if not any_run or (i >= chunk_steps and changed):
                return i
            for _ in range(HOST_CHECK_STEPS):
                self._step(s, gen, **kw)
            i += HOST_CHECK_STEPS

    def _job_rows(self, jobs: Dict[str, np.ndarray], rows
                  ) -> Dict[str, torch.Tensor]:
        """The fields of the jobs ``rows`` (one a slot of this rank) copied
        from the host arrays to the device."""
        r = np.asarray(rows)
        return {f: torch.from_numpy(a[r]).to(self.device)
                for f, a in jobs.items()}

    def _refill(self, s: Dict, jobs: Dict[str, np.ndarray],
                slot_job: List[Optional[int]], queue, slots) -> List[int]:
        """Give each of ``slots`` (over all B) the next job of ``queue``, or
        IDLE once it is empty, in one ``_rearm`` of this rank's rows;
        returns the jobs armed."""
        B, mine = self.batch, self.rows
        mask, idle, rows = np.zeros(B, bool), np.zeros(B, bool), [0] * B
        armed = []
        for b in slots:
            j = slot_job[b] = next(queue, None)
            if j is None:
                idle[b] = True
            else:
                mask[b], rows[b] = True, j
                armed.append(j)
        self._rearm(s, mask[mine], idle[mine], self._job_rows(jobs, rows[mine]))
        return armed

    def _serve(self, jobs: Optional[Dict[str, np.ndarray]], n: int, *,
               seed: int, chunk_steps: int, fields: Dict[str, str],
               result: Callable, **step_kw) -> Tuple[List, dict]:
        """Continuous batching of the ``n`` jobs in ``jobs`` (None when n is
        0) through the B slots (module docstring).  ``fields`` maps each
        per-job stat to its state entry ('status' and 'events' among them);
        ``result(out_row, events, status)`` makes a finished job's output;
        ``step_kw`` goes to every ``_step``.

        Returns (outputs, stats) in submission order; ``stats`` has the
        per-job ``fields``, ``wall_seconds`` (= ``seconds``), ``chunks``
        (host refill round trips) and ``steps`` (loop steps over all slots),
        and per job ``admitted_s`` and ``finished_s``: seconds from the
        call's start to the end of the chunk that armed its slot or
        harvested it (the first slots' jobs: to the end of the state's
        set-up)."""
        if n == 0:
            return [], {'seconds': 0.0, 'wall_seconds': 0.0, 'chunks': 0,
                        'steps': 0, 'admitted_s': [], 'finished_s': [],
                        **{k: [] for k in fields}}
        t0 = time.time()
        gen = self._generator(seed)
        B, first = self.batch, min(self.batch, n)
        slot_job: List[Optional[int]] = [None] * B
        queue = iter(range(n))
        s = self._open(jobs)
        self._refill(s, jobs, slot_job, queue, range(B))
        admitted_s = [time.time() - t0] * first + [0.0] * (n - first)
        finished_s = [0.0] * n
        outputs: List = [None] * n
        per_job = {k: [0] * n for k in fields}
        col = {k: 1 + i for i, k in enumerate(fields)}
        chunks = steps = 0
        while any(j is not None for j in slot_job):
            steps += self._run_chunk(s, gen, chunk_steps, **step_kw)
            chunks += 1
            with span('emodis.serve.refill'):
                got = gather_rows(self.mesh, torch.stack(
                    [self._running(s).long()] + [s[f] for f in fields.values()],
                    1))
                now = time.time() - t0
                finished = [b for b in range(B)
                            if slot_job[b] is not None and not got[b, 0]]
                out = gather_rows(self.mesh, s['out'])
                for b in finished:
                    j = slot_job[b]
                    outputs[j] = result(out[b], got[b, col['events']],
                                        got[b, col['status']])
                    finished_s[j] = now
                    for k in fields:
                        per_job[k][j] = int(got[b, col[k]])
                for j in self._refill(s, jobs, slot_job, queue, finished):
                    admitted_s[j] = now
        secs = time.time() - t0
        return outputs, {'seconds': secs, 'wall_seconds': secs,
                         'chunks': chunks, 'steps': steps, **per_job,
                         'admitted_s': admitted_s, 'finished_s': finished_s}
