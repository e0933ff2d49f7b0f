"""Batched stage-1 generation: B lead sheets in one device loop.

Port of ``emo_disentanger_tpu/infer/stage1_batch.py``.  The reference's
retry semantics (the XL cache grows on every iteration, accepted or
rejected) let all songs advance the cache in lockstep with one shared write
position, so ``generate`` decodes a whole batch together and finished songs
idle until all are done; prompt-continuation primers are teacher-forced
first (a song with a shorter primer starts sampling sooner).  The step
attends over the whole cache (``full_attention=True``, as JAX pins it).

Cache ladder.  The whole-cache attention costs O(Kmax) a step, and Kmax =
max_events + reject_slack sizes for the worst song.  ``generate`` therefore
runs a ladder of cache sizes, [max_events + fast_slack, max_events +
reject_slack] by default: the step whose clock reaches a tier's last row
marks the running songs OVERFLOW, they return to RUNNING and the same
state and random stream continue in the next tier, with no replayed step.
Attention masks the positions past the clock, so the streams are the
single-tier run's.  The tiers are leading views of one cache of the full
size, so moving up copies nothing.

``serve`` streams N jobs through the B slots with a clock per slot
(``decode_step_pe``) at the full Kmax with no ladder (an OVERFLOW is
final there).  The host reads the status every ``HOST_CHECK_STEPS`` steps;
after a slot finishes and at least ``chunk_steps`` steps have passed, one
masked update re-arms every finished slot with the next queued job.  A
refilled slot needs no cache clear: it writes from position 0 and attends
only to positions <= its clock.  Slots that are not running keep stepping
and their clocks keep counting; a clock past the cache writes its last row
(clamped) and is a dead slot until a refill.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.vocab import Vocab
from ..models.txl import PlainTransformer
from .stage1 import (
    HOST_CHECK_STEPS, STATUS_IDLE, STATUS_OVERFLOW, STATUS_RUNNING,
    SongLoop)


class Stage1BatchGenerator(SongLoop):
    """Generate B songs at once (emotion-token primers or full
    prompt-continuation primers), or serve N jobs through B slots."""

    def __init__(self, model: PlainTransformer, vocab: Vocab, *,
                 batch: int = 8, temp: float = 1.2, top_p: float = 0.97,
                 max_events: int = 512, max_bars: int = 128,
                 reject_slack: int = 1024,
                 fast_slack: Optional[int] = 256,
                 tiers: Optional[Sequence[int]] = None, mesh=None,
                 device: Union[str, torch.device] = 'cuda'):
        """``fast_slack``: the ladder [max_events + fast_slack, max_events +
        reject_slack] (None: one tier).  ``tiers`` overrides it with
        explicit intermediate sizes (values below max_events are legal: a
        song that spills mid-primer continues in the next tier).  ``mesh``:
        multi-device serving is not ported; a mesh of more than one device
        is refused."""
        if mesh is not None:
            size = mesh.size() if callable(getattr(mesh, 'size', None)) \
                else getattr(mesh, 'size', 1)
            if size > 1:
                raise NotImplementedError(
                    'the port serves on one device; multi-device serving is '
                    'not ported')
        super().__init__(model, vocab, batch=batch, temp=temp, top_p=top_p,
                         max_events=max_events, max_bars=max_bars,
                         device=device)
        self.full_klen = max_events + reject_slack
        if tiers is None:
            tiers = ([max_events + fast_slack]
                     if fast_slack is not None and fast_slack < reject_slack
                     else [])
        self.klens = sorted({int(k) for k in tiers if 0 < k < self.full_klen})
        self.klens.append(self.full_klen)

    @torch.no_grad()
    def generate(self, emotions: List[str], seed: int = 0, target_bars=None,
                 primers: Optional[List[List[str]]] = None,
                 prompt_bars: Optional[List[int]] = None,
                 ) -> Tuple[List[Optional[List[str]]], dict]:
        """Lockstep generation of ``batch`` songs through the cache
        ladder.  ``primers``: optional per-song event lists for prompt
        continuation (each starting with its Emotion token).  Returns
        (songs, stats); a stuck song is None.  ``stats['resumed']`` counts
        the songs that continued in a larger tier, summed over the moves,
        and ``stats['iters']`` the loop steps over all tiers (with up to
        HOST_CHECK_STEPS - 1 after the last song finished)."""
        if len(emotions) != self.batch:
            raise ValueError(f'generate takes exactly batch={self.batch} songs')
        jobs = self._jobs(emotions, primers, prompt_bars, target_bars)
        t0 = time.time()
        gen = self._generator(seed)
        s = self._fresh(jobs, list(range(self.batch)))
        full = self.model.init_decode_cache(self.batch, self.full_klen)
        s['t'] = 0
        iters = resumed = 0
        for i, klen in enumerate(self.klens):
            if i > 0:
                overflow = s['status'] == STATUS_OVERFLOW
                n = int(overflow.sum())
                if n == 0:
                    break
                resumed += n
                s['status'] = torch.where(overflow, STATUS_RUNNING, s['status'])
            # the tier: the first klen positions of the full cache; the
            # position heads stay whole (they are indexed by distance)
            s['cache'] = {'k': full['k'][:, :, :klen],
                          'v': full['v'][:, :, :klen], 'r': full['r']}
            iters = self._lockstep(s, gen, iters, max_klen=klen,
                                   full_attention=True)
        out = s['out'].cpu().numpy()
        out_len = s['out_len'].cpu().numpy()
        status = s['status'].cpu().numpy()
        songs = [self._song(out[b], out_len[b], status[b])
                 for b in range(self.batch)]
        stats = {'seconds': time.time() - t0, 'status': status.tolist(),
                 'bars': s['bars'].cpu().tolist(), 'events': out_len.tolist(),
                 'rejects': s['rejects'].cpu().tolist(), 'resumed': resumed,
                 'iters': iters}
        return songs, stats

    def _poll(self, s: Dict, entry: torch.Tensor) -> Tuple[bool, bool]:
        """One host read: (any slot running, the running set differs from
        ``entry``)."""
        run = self._running(s)
        any_run, changed = torch.stack(
            [run.any(), (run != entry).any()]).tolist()
        return bool(any_run), bool(changed)

    def _run_chunk(self, s: Dict, gen: torch.Generator, chunk_steps: int) -> int:
        """Step until nothing runs, or a slot has finished and at least
        ``chunk_steps`` steps have passed (checked every HOST_CHECK_STEPS
        steps); returns the steps run."""
        entry = self._running(s)
        i = 0
        while True:
            any_run, changed = self._poll(s, entry)
            if not any_run or (i >= chunk_steps and changed):
                return i
            for _ in range(HOST_CHECK_STEPS):
                self._step(s, gen, max_klen=self.full_klen)
            i += HOST_CHECK_STEPS

    def _refill(self, s: Dict, mask: np.ndarray, idle: np.ndarray,
                jobs: Dict[str, np.ndarray], rows) -> None:
        """One masked update: the slots in ``mask`` take the jobs ``rows``
        (B-shaped, unmasked entries ignored) with fresh counters and clock
        0; the slots in ``idle`` become IDLE."""
        m = torch.from_numpy(mask).to(self.device)
        fresh = self._fresh(jobs, rows)
        for k, v in fresh.items():
            s[k] = torch.where(m.reshape((-1,) + (1,) * (v.dim() - 1)), v, s[k])
        s['t'] = torch.where(m, 0, s['t'])
        s['status'] = torch.where(torch.from_numpy(idle).to(self.device),
                                  STATUS_IDLE, s['status'])

    @torch.no_grad()
    def serve(self, emotions: List[str], *, seed: int = 0, target_bars=None,
              chunk_steps: int = 128,
              primers: Optional[List[List[str]]] = None,
              prompt_bars: Optional[List[int]] = None,
              ) -> Tuple[List[Optional[List[str]]], dict]:
        """Continuous batching of N jobs through the B slots
        (``stage1_batch.py:397-556``); ``primers`` / ``prompt_bars`` as in
        :meth:`generate`.  Returns (songs,
        stats) in submission order; ``stats`` has the per-job fields of
        :meth:`generate`, ``chunks`` (host refill round trips) and
        ``steps`` (loop steps)."""
        N, B = len(emotions), self.batch
        fields = ('status', 'bars', 'events', 'rejects')
        if N == 0:
            return [], {'seconds': 0.0, 'chunks': 0, 'steps': 0,
                        'resumed': 0, **{k: [] for k in fields}}
        jobs = self._jobs(emotions, primers, prompt_bars, target_bars)
        t0 = time.time()
        gen = self._generator(seed)
        first = min(B, N)
        slot_job: List[Optional[int]] = list(range(first)) + [None] * (B - first)
        s = self._fresh(jobs, list(range(first)) + [0] * (B - first))
        s['cache'] = self.model.init_decode_cache(B, self.full_klen)
        s['t'] = torch.zeros(B, dtype=torch.long, device=self.device)
        idle = np.arange(B) >= first
        if idle.any():
            s['status'] = torch.where(torch.from_numpy(idle).to(self.device),
                                      STATUS_IDLE, s['status'])
        next_job = first
        songs: List[Optional[List[str]]] = [None] * N
        per_job = {k: [0] * N for k in fields}
        chunks = steps = 0
        while True:
            steps += self._run_chunk(s, gen, chunk_steps)
            chunks += 1
            run = self._running(s).cpu().numpy()
            status = s['status'].cpu().numpy()
            finished = [b for b in range(B) if slot_job[b] is not None
                        and not run[b]]
            if not finished:
                if not run.any():
                    break
                continue
            out = s['out'].cpu().numpy()
            got = {'status': status, 'events': s['out_len'].cpu().numpy(),
                   'bars': s['bars'].cpu().numpy(),
                   'rejects': s['rejects'].cpu().numpy()}
            for b in finished:
                j = slot_job[b]
                songs[j] = self._song(out[b], got['events'][b], status[b])
                for k in fields:
                    per_job[k][j] = int(got[k][b])
            mask = np.zeros(B, bool)
            idle = np.zeros(B, bool)
            rows = [0] * B
            for b in finished:
                if next_job < N:
                    mask[b] = True
                    rows[b] = next_job
                    slot_job[b] = next_job
                    next_job += 1
                else:
                    idle[b] = True
                    slot_job[b] = None
            self._refill(s, mask, idle, jobs, rows)
        return songs, {'seconds': time.time() - t0, 'chunks': chunks,
                       'steps': steps, 'resumed': 0, **per_job}
