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
single-tier run's.  The tiers are leading views along K of one cache of the
full size (K is the third axis of a layer's cache in 'khd', the fourth in
'hkd', the last in 'dk'), so moving up copies nothing; in the head-major
layouts such a view is still one batched matrix a (b, h) at one stride, so
the attention reads it in place.

``serve`` streams N jobs through the B slots in ``slots.SlotLoop``'s
queue loop, with a clock per slot (``decode_step_pe``) at the full Kmax and
no ladder (an OVERFLOW is final there).  A re-armed slot needs no cache
clear: it writes from position 0 and attends only to positions <= its
clock.  Slots that are not running keep stepping and their clocks keep
counting; a clock past the cache writes its last row (clamped) and is a
dead slot until a refill.

Over a ``mesh`` whose data axes (dp * dcn) exceed one, each rank runs its
B / (dp * dcn) rows (``SongLoop``).  The ladder's tier moves are decided on
the global status, so every rank moves at the same step.  Both
``generate`` and ``serve`` return the global songs and stats on every rank.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.vocab import Vocab
from ..models.txl import PlainTransformer
from ..ops.attention import K_AXIS
from ..parallel.mesh import gather_rows, reduce_flags
from .stage1 import STATUS_IDLE, STATUS_OVERFLOW, STATUS_RUNNING, SongLoop

# serve's per-job stats and the state entries they are read from
SERVE_FIELDS = {'status': 'status', 'bars': 'bars', 'events': 'out_len',
                'rejects': 'rejects'}


class Stage1BatchGenerator(SongLoop):
    """Generate B songs at once (emotion-token primers or full
    prompt-continuation primers), or serve N jobs through B slots."""

    def __init__(self, model: PlainTransformer, vocab: Vocab, *,
                 batch: int = 8, temp: float = 1.2, top_p: float = 0.97,
                 max_events: int = 512, max_bars: int = 128,
                 functional: bool = True, reject_slack: int = 1024,
                 fast_slack: Optional[int] = 256,
                 tiers: Optional[Sequence[int]] = None, mesh=None,
                 cache_layout: Optional[str] = None,
                 device: Union[str, torch.device] = 'cuda'):
        """``fast_slack``: the ladder [max_events + fast_slack, max_events +
        reject_slack] (None: one tier).  ``tiers`` overrides it with
        explicit intermediate sizes (values below max_events are legal: a
        song that spills mid-primer continues in the next tier).  ``mesh``
        splits the ``batch`` songs over its data axes (``batch`` must divide
        by dp * dcn).  ``functional=False`` decodes REMI: no key step.
        ``cache_layout``: 'khd', 'hkd' or 'dk' (``stage1`` module
        docstring)."""
        super().__init__(model, vocab, batch=batch, temp=temp, top_p=top_p,
                         max_events=max_events, max_bars=max_bars,
                         device=device, functional=functional, mesh=mesh,
                         cache_layout=cache_layout)
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
        s = self._fresh(self._job_rows(jobs,
                                       list(range(self.batch))[self.rows]))
        full = self.model.init_decode_cache(self.nb, self.full_klen,
                                            self.cache_layout)
        k_axis = 1 + K_AXIS[self.cache_layout]      # of [n_layer, B, ...]
        s['t'] = 0
        iters = resumed = 0
        for i, klen in enumerate(self.klens):
            if i > 0:
                overflow = s['status'] == STATUS_OVERFLOW
                n = reduce_flags(self.mesh, [int(overflow.sum())], 'sum')[0]
                if n == 0:
                    break
                resumed += n
                s['status'] = torch.where(overflow, STATUS_RUNNING, s['status'])
            # the tier: the first klen positions of the full cache; the
            # position heads stay whole (they are indexed by distance)
            s['cache'] = {'k': full['k'].narrow(k_axis, 0, klen),
                          'v': full['v'].narrow(k_axis, 0, klen),
                          'r': full['r']}
            iters = self._lockstep(s, gen, iters, max_klen=klen,
                                   full_attention=True)
        got = {k: gather_rows(self.mesh, s[k]) for k in (
            'out', 'out_len', 'status', 'bars', 'rejects')}
        out, out_len, status = got['out'], got['out_len'], got['status']
        songs = [self._song(out[b], out_len[b], status[b])
                 for b in range(self.batch)]
        stats = {'seconds': time.time() - t0, 'status': status.tolist(),
                 'bars': got['bars'].tolist(), 'events': out_len.tolist(),
                 'rejects': got['rejects'].tolist(), 'resumed': resumed,
                 'iters': iters}
        return songs, stats

    def _open(self, jobs: Dict[str, np.ndarray]) -> Dict:
        """``serve``'s state before its first re-arm: blank slots, a clock
        per slot and a cache of the full Kmax."""
        s = self._fresh({k: torch.zeros((self.nb,) + v.shape[1:],
                                        dtype=torch.from_numpy(v).dtype,
                                        device=self.device)
                         for k, v in jobs.items()})
        s['cache'] = self.model.init_decode_cache(self.nb, self.full_klen,
                                                  self.cache_layout)
        s['t'] = torch.zeros(self.nb, dtype=torch.long, device=self.device)
        return s

    def _rearm(self, s: Dict, mask: np.ndarray, idle: np.ndarray,
               rows: Dict[str, torch.Tensor]) -> None:
        """One masked update of this rank's slots: those in ``mask`` take
        their jobs from ``rows`` (``_job_rows``; unmasked rows ignored) with
        fresh counters and clock 0, those in ``idle`` become IDLE."""
        m = torch.from_numpy(mask).to(self.device)
        for k, v in self._fresh(rows).items():
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
        (``stage1_batch.py:397-556``; ``slots.SlotLoop._serve``);
        ``primers`` / ``prompt_bars`` as in :meth:`generate`.  Returns
        (songs, stats) in submission order; ``stats`` has the per-job fields
        of :meth:`generate` and the loop's ``chunks``, ``steps``,
        ``wall_seconds``, ``admitted_s`` and ``finished_s``."""
        jobs = (self._jobs(emotions, primers, prompt_bars, target_bars)
                if emotions else None)
        songs, stats = self._serve(jobs, len(emotions), seed=seed,
                                   chunk_steps=chunk_steps,
                                   fields=SERVE_FIELDS, result=self._song,
                                   max_klen=self.full_klen)
        return songs, {**stats, 'resumed': 0}
