"""Batched stage-2 generation: B performances stepped together.

Port of ``emo_disentanger_tpu/infer/stage2_batch.py``, both backbones.
Every batch element runs its own token stream with a private position
counter, and sampling and the per-bar teacher-forced lead-sheet injection
share one loop body:

* each element is either SAMPLING the full track or INJECTING the next
  lead-sheet bar from a precomputed token matrix;
* rejected samples (beat monotonicity, PAD, early EOS) leave that element's
  state and logits unchanged and resample, while other elements proceed;
  256 consecutive beat rejections mark the element STUCK, and a per-element
  step budget guards against runaways;
* every stream drops its final token, except a STUCK one.

The Performer carries per-layer FAVOR+ (S, z) state, whose masked update
freezes rejected elements.  GPT-2 writes its KV cache at per-element clocks;
a rejected element overwrites the same slot on its next step.  GPT-2
re-anchors its window inside the loop: when a sampling element's clock
reaches ``gpt2_cache_len - 2``, or a finished bar's next injection would
come within ``reanchor_margin`` of the cache end, one batched forward over
every element's trailing window (``gpt2_window`` tokens of its output)
rebuilds the flagged elements' caches, clocks and logits, so songs of any
length never truncate.  That forward runs the flash-attention kernel on the
card.  ``gpt2_tiers`` runs ``generate`` through ascending cache sizes: the
step on which any element reaches a tier's end hands back, the caches are
padded to the next tier and the same state continues, so streams equal the
single-cache run's (attention masks the positions past each clock).

Decode-state layouts, as JAX's generator picks them (``stage2_batch.py:
69-91``): GPT-2's KV cache in ``cache_layout`` 'khd' [n_layer, B, K, H, Dh]
or 'dk' [n_layer, B, H, Dh, K] (``EMODIS_S2_CACHE_LAYOUT`` when None, else
'khd'); the Performer's FAVOR+ state S in ``state_layout`` 'dm' or 'md'
(``EMODIS_PERF_STATE_LAYOUT`` when None, else 'dm').  The ladder pads and
the re-anchor writes along the cache's K axis in either layout.

The body is a Python loop over device tensors, and elements that are not
running are frozen by the status masks; the slots, the step's span, the
status poll and ``serve``'s queue are ``slots.SlotLoop``'s.  Each poll also
reads an upper bound of the clocks (``t_hi``), so the host reads the
re-anchor flags and the tier overflow each step only while some clock can
have reached them.  ``serve``'s re-arm zeroes a Performer slot's (S, z); a
GPT-2 slot overwrites its cache from position 0 before attending to it.

Data parallelism.  With a ``mesh`` whose data axes (dp * dcn) exceed one,
each rank runs its B / (dp * dcn) rows of the B slots (``mesh.local_rows``).
Every step draws ``torch.rand(B)`` uniforms on every rank and each keeps its
rows, so a row samples what it samples on one device.  The ranks stay in
lockstep through the poll's all-reduce (``slots``), and the tier moves are
decided on the global status; ``generate`` and ``serve`` return the global
streams and stats on every rank.  A re-anchor forward runs on the ranks
that hold a flagged element.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.vocab import Vocab
from ..models.gpt2 import MusicGPT2
from ..models.performer import MusicPerformer
from ..ops.sampling import nucleus_sample
from ..parallel.mesh import any_rows, gather_rows
from ..utils.profiling import accumulate, span
from .rules import build_rule_tables
from .slots import HOST_CHECK_STEPS, SlotLoop

STATUS_RUNNING = 0
STATUS_EOS = 2
STATUS_MAX = 3
STATUS_STUCK = 4
STATUS_DONE_BARS = 5
STATUS_IDLE = 6          # serve(): slot drained, no job to refill
STATUS_OVERFLOW = 7      # gpt2_tiers: element outgrew this tier's cache

MODE_SAMPLE = 0
MODE_INJECT = 1

_JOB_FIELDS = ('inj_tokens', 'inj_segs', 'inj_len', 'primer', 'primer_len',
               'target_bars')
_COUNTERS = ('t', 'primer_pos', 'bars', 'inj_pos', 'cur_pos', 'failed',
             'rejects', 'esteps', 'reanchors')
# serve's per-job stats and the state entries they are read from
SERVE_FIELDS = {'status': 'status', 'bars': 'bars', 'events': 'out_len',
                'reanchors': 'reanchors', 'rejects': 'rejects'}


class Stage2BatchGenerator(SlotLoop):
    """Whole-batch stage-2 generation (Performer or GPT-2) on one device,
    or data-parallel over a mesh (module docstring)."""

    def __init__(self, model, vocab: Vocab, *, batch: int, temp: float = 1.1,
                 top_p: float = 0.99, max_events: int = 10000,
                 max_bar_tokens: int = 256, max_bars: int = 128,
                 gpt2_cache_len: int = 4096, gpt2_window: int = 2048,
                 reanchor_margin: int = 256, serve_chunk_steps: int = 192,
                 omegas: Optional[torch.Tensor] = None,
                 gpt2_tiers: Optional[Sequence[int]] = None, mesh=None,
                 cache_layout: Optional[str] = None,
                 state_layout: Optional[str] = None,
                 device: Union[str, torch.device] = 'cuda'):
        """``batch`` counts the slots over all ranks; ``mesh`` splits them
        over its data axes (``batch`` must divide by dp * dcn).
        ``cache_layout`` / ``state_layout``: the module docstring."""
        self.cache_layout = (cache_layout if cache_layout is not None else
                             os.environ.get('EMODIS_S2_CACHE_LAYOUT', 'khd'))
        if self.cache_layout not in ('khd', 'dk'):
            raise ValueError(f"cache_layout must be 'khd' or 'dk' (got "
                             f'{self.cache_layout!r})')
        self.state_layout = (state_layout if state_layout is not None else
                             os.environ.get('EMODIS_PERF_STATE_LAYOUT', 'dm'))
        if self.state_layout not in ('dm', 'md'):
            raise ValueError(f"state_layout must be 'dm' or 'md' (got "
                             f'{self.state_layout!r})')
        # the K axis of the GPT-2 cache [n_layer, B, ...]
        self._k_axis = 2 if self.cache_layout == 'khd' else 4
        self.is_performer = isinstance(model, MusicPerformer)
        if not self.is_performer and not isinstance(model, MusicGPT2):
            raise TypeError(f'expected MusicPerformer or MusicGPT2, got '
                            f'{type(model).__name__}')
        super().__init__(model, batch=batch, mesh=mesh, device=device)
        if self.is_performer:
            if omegas is None:
                raise ValueError('Performer decoding needs drawn omegas')
            if omegas.device != self.device:
                raise ValueError(f'omegas on {omegas.device}; expected '
                                 f'{self.device}')
            self.omegas = omegas.float().contiguous()
        else:
            # a re-anchor resets t to <= window; a whole injected bar must
            # then fit before the mid-bar guard
            if gpt2_cache_len - 2 < gpt2_window + max_bar_tokens:
                raise ValueError('gpt2_cache_len must cover gpt2_window + '
                                 'max_bar_tokens + 2')
            if model.training:
                raise ValueError('GPT-2 re-anchors run the deterministic '
                                 'forward; call model.eval() first')
        self.vocab = vocab
        self.temp = temp
        self.top_p = top_p
        self.max_events = max_events
        self.max_bar_tokens = max_bar_tokens
        self.max_bars = max_bars
        self.gpt2_cache_len = gpt2_cache_len
        self.gpt2_window = gpt2_window
        self.reanchor_margin = reanchor_margin
        self.serve_chunk_steps = serve_chunk_steps
        self.max_iters = max_events * 2 + 8192
        # no clock below this can raise a re-anchor flag (mid-bar guard or
        # bar-boundary margin)
        self._reanchor_from = gpt2_cache_len - max(2, max_bar_tokens
                                                   + reanchor_margin)
        # the GPT-2 cache ladder; the Performer ignores it, as in JAX.  A
        # tier must be out of reach of both re-anchor triggers, so the only
        # in-tier guard is the cache end
        self.tiers: List[int] = []
        if gpt2_tiers and not self.is_performer:
            hi = gpt2_cache_len - max_bar_tokens - reanchor_margin - 2
            self.tiers = sorted({int(k) for k in gpt2_tiers if 16 <= k < hi})
            if not self.tiers:
                raise ValueError(f'gpt2_tiers must contain values in [16, {hi}) '
                                 f'(got {list(gpt2_tiers)})')
        tb = build_rule_tables(vocab)
        on_dev = lambda a: torch.as_tensor(a, device=self.device)
        self._is_beat = on_dev(tb.is_beat)
        self._beat_pos = on_dev(tb.beat_pos.astype(np.int64))
        self._is_pad = on_dev(tb.is_pad)
        self._is_eos = on_dev(tb.is_eos)
        self._is_lead = on_dev(tb.is_track_lead)
        self._ar = torch.arange(self.nb, device=self.device)

    # ---- the loop body ----

    def _cache_len(self, s: Dict) -> int:
        return s['state']['k'].shape[self._k_axis]

    def _advance(self, s: Dict, gen: torch.Generator, counting: bool) -> None:
        gpt2 = not self.is_performer
        in_tier = gpt2 and self._cache_len(s) < self.gpt2_cache_len
        if gpt2 and not in_tier:
            # checked before sampling, so this step samples from the
            # re-anchored logits
            self._maybe_reanchor(s)
        ar = self._ar
        act = s['status'] == STATUS_RUNNING
        if counting:
            self._count_step(s, act)
        in_primer, mode = s['in_primer'], s['mode']

        # --- choose this step's token per element ---
        u = torch.rand(self.batch, generator=gen, device=self.device)
        with span('emodis.serve.sample'):
            sampled = nucleus_sample(s['logits'], self.temp, self.top_p,
                                     u[self.rows])
        prim_tok = s['primer'].gather(1, s['primer_pos'].clamp(
            0, s['primer'].shape[1] - 1)[:, None])[:, 0]
        bar_idx = s['bars'].clamp(max=self.max_bars - 1)
        ipos = s['inj_pos'].clamp(max=self.max_bar_tokens - 1)
        inj_tok = s['inj_tokens'][ar, bar_idx, ipos]
        inj_seg = s['inj_segs'][ar, bar_idx, ipos]

        injecting = (mode == MODE_INJECT) & ~in_primer
        token = torch.where(in_primer, prim_tok,
                            torch.where(injecting, inj_tok, sampled))
        is_lead = self._is_lead[token]
        seg = torch.where(in_primer, 0, torch.where(
            injecting, inj_seg, (~is_lead).long()))

        # --- sampling rules (only in SAMPLE mode) ---
        sampling = (mode == MODE_SAMPLE) & ~in_primer
        is_beat = self._is_beat[token]
        beat_bad = sampling & is_beat & (self._beat_pos[token] < s['cur_pos'])
        eos_early = (sampling & self._is_eos[token]
                     & (s['bars'] < s['target_bars'] - 1))
        reject = (beat_bad | (sampling & self._is_pad[token]) | eos_early) & act
        failed = torch.where(beat_bad & act, s['failed'] + 1, torch.where(
            sampling & is_beat & act, 0, s['failed']))
        stuck = failed >= 256

        # --- the model runs for everyone; masked elements' state is frozen
        # (Performer) or their cache slot is rewritten next step (GPT-2) ---
        advance = act & ~reject
        if self.is_performer:
            new_logits, _ = self.model.decode_step_batchpos(
                token, seg, s['t'], self.omegas, s['state'], update_mask=advance,
                state_layout=self.state_layout)
        else:
            new_logits, _ = self.model.decode_step_batchpos(
                token, seg, s['t'], s['state'], self.cache_layout)
        s['logits'] = torch.where(advance[:, None], new_logits, s['logits'])
        s['t'] = s['t'] + advance
        s['t_hi'] += 1

        # --- bookkeeping ---
        append = advance & ~in_primer
        idx = s['out_len'].clamp(max=self.max_events + 7)
        for buf, val in (('out', token), ('out_segs', seg)):
            s[buf][ar, idx] = torch.where(append, val, s[buf][ar, idx])
        s['out_len'] = s['out_len'] + append

        primer_pos = s['primer_pos'] + (advance & in_primer)
        s['primer_pos'] = primer_pos
        s['in_primer'] = in_primer & (primer_pos < s['primer_len'])

        # injection progress: finishing the bar's row switches to sampling
        bar_len = s['inj_len'][ar, bar_idx]
        inj_pos = torch.where(injecting & advance, s['inj_pos'] + 1, s['inj_pos'])
        inj_done = injecting & advance & (inj_pos >= bar_len)
        mode = torch.where(inj_done, MODE_SAMPLE, mode)
        cur_pos = torch.where(inj_done, 0, s['cur_pos'])

        # a sampled Track_LeadSheet closes the bar: inject the next one
        bar_done = sampling & advance & is_lead
        bars = s['bars'] + bar_done
        more = bars < s['target_bars']
        s['mode'] = torch.where(bar_done & more, MODE_INJECT, mode)
        s['inj_pos'] = torch.where(bar_done, 0, inj_pos)
        s['cur_pos'] = torch.where(sampling & advance & is_beat,
                                   self._beat_pos[token], cur_pos)
        s['bars'] = bars
        if gpt2:
            # bar-boundary trigger: re-anchor before injecting a bar that
            # would come within the margin of the cache end
            next_len = s['inj_len'][ar, bars.clamp(max=self.max_bars - 1)]
            s['need_re'] = s['need_re'] | (
                bar_done & more & (s['t'] + next_len + self.reanchor_margin
                                   >= self.gpt2_cache_len))

        eos_final = sampling & advance & self._is_eos[token] & ~eos_early
        esteps = s['esteps'] + act
        status = torch.where(act & stuck, STATUS_STUCK, s['status'])
        status = torch.where(act & (esteps >= self.max_iters), STATUS_STUCK,
                             status)
        status = torch.where(act & eos_final, STATUS_EOS, status)
        status = torch.where(act & (s['out_len'] > self.max_events),
                             STATUS_MAX, status)
        status = torch.where(act & bar_done & ~more, STATUS_DONE_BARS, status)
        if in_tier:
            # this step wrote at t - 1 < tier; flag before the next write
            # would pass the cache end (a song finishing now stays finished)
            status = torch.where((status == STATUS_RUNNING) & act
                                 & (s['t'] >= self._cache_len(s) - 2),
                                 STATUS_OVERFLOW, status)
        s['status'] = status
        s['esteps'] = esteps
        s['failed'] = failed
        s['rejects'] = s['rejects'] + reject

    def _count_step(self, s: Dict, act: torch.Tensor) -> None:
        """Add the step's running slots (GPT-2: and the sum of their clocks)
        to the device accumulator that ``_poll`` flushes into ``COUNTS``
        through its one host read.  Each rank counts its own slots."""
        accumulate(s, act.sum()[None] if self.is_performer else
                   torch.stack([act.sum(), (s['t'] * act).sum()]))

    def _maybe_reanchor(self, s: Dict) -> None:
        if s['t_hi'] < self._reanchor_from:
            return                       # no clock can have reached a trigger
        mid = ((s['status'] == STATUS_RUNNING) & ~s['in_primer']
               & (s['mode'] == MODE_SAMPLE)
               & (s['t'] >= self.gpt2_cache_len - 2))
        s['need_re'] = s['need_re'] | mid
        if bool(s['need_re'].any()):
            self._reanchor_all(s)

    def _reanchor_all(self, s: Dict) -> None:
        """One batched forward over every element's trailing window of its
        output; the flagged elements take its k/v as their cache (zero past
        the window), its logits at their last real token, and that token's
        count as their clock."""
        out = s['out']
        W = min(self.gpt2_window, out.shape[1])
        pos = torch.arange(W, device=self.device)
        start = (s['out_len'] - W).clamp(0, out.shape[1] - W)
        keep_len = s['out_len'].clamp(max=W)
        valid = pos[None] < keep_len[:, None]
        rows = start[:, None] + pos
        toks = torch.where(valid, out.gather(1, rows), self.vocab.pad_id)
        segs = torch.where(valid, s['out_segs'].gather(1, rows), 0)
        logits, k, v = self.model(toks, segs, return_kv=True)
        flag = s['need_re']
        s['logits'] = torch.where(
            flag[:, None], logits[self._ar, (keep_len - 1).clamp(min=0)],
            s['logits'])
        sel = flag.nonzero()[:, 0]
        for name, new in (('k', k), ('v', v)):
            cache = s['state'][name]
            new = new[:, sel].to(cache.dtype)          # [n_layer, n, W, H, Dh]
            if self.cache_layout == 'khd':
                cache[:, sel, :W] = new
                cache[:, sel, W:] = 0
            else:
                cache[:, sel, ..., :W] = new.permute(0, 1, 3, 4, 2)
                cache[:, sel, ..., W:] = 0
        s['t'] = torch.where(flag, keep_len, s['t'])
        s['reanchors'] = s['reanchors'] + flag
        s['need_re'] = torch.zeros_like(flag)

    def _running(self, s: Dict) -> torch.Tensor:
        return s['status'] == STATUS_RUNNING

    def _bounds(self, s: Dict) -> Dict[str, torch.Tensor]:
        """The poll refreshes the host's bound on the clocks."""
        return {'t_hi': s['t'].max()}

    # ---- jobs and slots ----

    def _prep_jobs(self, primers, lead_sheet_bars, max_bars):
        """Pack N jobs into padded int64 arrays [N, ...] (N need not be B)."""
        N = len(primers)
        track_full = self.vocab.event2idx['Track_Full']
        track_lead = self.vocab.event2idx['Track_LeadSheet']
        if max(len(bars) for bars in lead_sheet_bars) > self.max_bars:
            raise ValueError(f'a job has more than max_bars={self.max_bars} '
                             'lead-sheet bars')
        inj_tokens = np.zeros((N, self.max_bars, self.max_bar_tokens), np.int64)
        inj_segs = np.zeros((N, self.max_bars, self.max_bar_tokens), np.int64)
        inj_len = np.zeros((N, self.max_bars), np.int64)
        target_bars = np.zeros(N, np.int64)
        prim_rows = []
        for b, (primer, bars) in enumerate(zip(primers, lead_sheet_bars)):
            target_bars[b] = len(bars) if max_bars is None else min(max_bars,
                                                                    len(bars))
            for k, bar in enumerate(bars):
                # the sampled Track_LeadSheet opens the bar; inject the bar's
                # events and the Track_Full terminator
                row = list(bar) + [track_full]
                if len(row) > self.max_bar_tokens:
                    raise ValueError(
                        f'lead-sheet bar {k} of element {b} has {len(bar)} '
                        f'tokens; bar + Track_Full terminator exceeds '
                        f'max_bar_tokens={self.max_bar_tokens}')
                inj_tokens[b, k, :len(row)] = row
                inj_segs[b, k, :len(row)] = [0] * (len(row) - 1) + [1]
                inj_len[b, k] = len(row)
            # the primer phase feeds primer + Track_LeadSheet
            prim_rows.append(list(primer) + [track_lead])
        # primer pad bucketed to 16, as the JAX generator does
        pmax = max(16, -(-max(len(p) for p in prim_rows) // 16) * 16)
        primer_arr = np.zeros((N, pmax), np.int64)
        primer_len = np.zeros(N, np.int64)
        for b, p in enumerate(prim_rows):
            primer_arr[b, :len(p)] = p
            primer_len[b] = len(p)
        return dict(inj_tokens=inj_tokens, inj_segs=inj_segs, inj_len=inj_len,
                    primer=primer_arr, primer_len=primer_len,
                    target_bars=target_bars)

    def _rearm(self, s: Dict, mask: np.ndarray, idle: np.ndarray,
               rows: Dict[str, torch.Tensor]) -> None:
        """One masked update that re-arms every slot in ``mask`` with its job
        from ``rows`` (``_job_rows``; unmasked rows ignored) and idles the
        slots in ``idle``.  A Performer slot's (S, z) is zeroed (the masked
        update ADDS to it); a GPT-2 slot needs no clear, since it overwrites
        each cache position before attending to it."""
        B = self.nb
        m = torch.from_numpy(mask).to(self.device)
        bmask = lambda t: m.reshape((B,) + (1,) * (t.dim() - 1))
        for f in _JOB_FIELDS:
            s[f] = torch.where(bmask(rows[f]), rows[f], s[f])
        fresh_out = torch.zeros_like(s['out'])
        fresh_out[:, :rows['primer'].shape[1]] = rows['primer']
        s['out'] = torch.where(bmask(fresh_out), fresh_out, s['out'])
        s['out_segs'] = torch.where(bmask(s['out_segs']), 0, s['out_segs'])
        s['logits'] = torch.where(bmask(s['logits']), 0.0, s['logits'])
        for f in _COUNTERS:
            s[f] = torch.where(m, 0, s[f])
        s['out_len'] = torch.where(m, rows['primer_len'], s['out_len'])
        s['mode'] = torch.where(m, MODE_INJECT, s['mode'])
        s['in_primer'] = s['in_primer'] | m
        s['need_re'] = s['need_re'] & ~m
        s['status'] = torch.where(m, STATUS_RUNNING, torch.where(
            torch.from_numpy(idle).to(self.device), STATUS_IDLE, s['status']))
        if self.is_performer:
            keep = (~m).float()
            for a in s['state'].values():          # [n_layer, B, ...]
                a.mul_(keep.reshape((1, B) + (1,) * (a.dim() - 2)))

    def _init_state(self, jobs: Dict[str, np.ndarray], rows,
                    cache_len: Optional[int] = None) -> Dict:
        """A fresh state with the jobs of ``rows`` in this rank's slots; a
        GPT-2 cache of ``cache_len`` positions (``gpt2_cache_len`` when
        None)."""
        s = self._open(jobs, cache_len)
        self._rearm(s, np.ones(self.nb, bool), np.zeros(self.nb, bool),
                    self._job_rows(jobs, rows))
        return s

    def _open(self, jobs: Dict[str, np.ndarray],
              cache_len: Optional[int] = None) -> Dict:
        """A state of blank slots, to be armed or idled by ``_rearm``."""
        B, dev = self.nb, self.device
        zl = lambda *shape: torch.zeros(shape, dtype=torch.long, device=dev)
        state = (self.model.init_decode_state(B, self.state_layout)
                 if self.is_performer else
                 self.model.init_decode_cache(B, cache_len or self.gpt2_cache_len,
                                              self.cache_layout))
        s = {'state': state,
             'out': zl(B, self.max_events + 8),
             'out_segs': zl(B, self.max_events + 8),
             'out_len': zl(B), 'mode': zl(B), 'status': zl(B),
             'in_primer': torch.zeros(B, dtype=torch.bool, device=dev),
             'need_re': torch.zeros(B, dtype=torch.bool, device=dev),
             'logits': torch.zeros(B, self.vocab.size, dtype=torch.float32,
                                   device=dev),
             't_hi': 0}
        s.update({f: zl(B) for f in _COUNTERS})
        s.update({f: zl(B, *jobs[f].shape[1:]) for f in _JOB_FIELDS})
        return s

    @staticmethod
    def _stream(out_row: np.ndarray, n: int, status: int) -> List[int]:
        """A stuck model returns its full partial stream; every other
        termination drops the final token, as the reference does."""
        toks = out_row[:n].tolist()
        return toks if status == STATUS_STUCK else toks[:-1]

    # ---- generate / serve ----

    def _lockstep(self, s: Dict, gen: torch.Generator, iters: int) -> int:
        """Step until nothing runs or ``max_iters`` steps in all; inside a
        ladder tier, also stop on the step that flags an overflow.  Returns
        the step count."""
        tier = (self._cache_len(s) if not self.is_performer
                and self._cache_len(s) < self.gpt2_cache_len else None)
        while iters < self.max_iters and self._poll(s)[0]:
            for _ in range(min(HOST_CHECK_STEPS, self.max_iters - iters)):
                self._step(s, gen)
                iters += 1
                if (tier is not None and s['t_hi'] >= tier - 2
                        and any_rows(self.mesh,
                                     s['status'] == STATUS_OVERFLOW)):
                    return iters
        return iters

    @torch.no_grad()
    def generate(self, primers: Sequence[Sequence[int]],
                 lead_sheet_bars: Sequence[List[List[int]]], *,
                 seed: int = 0, max_bars: Optional[int] = None,
                 ) -> Tuple[List[List[int]], dict]:
        """Lockstep: B jobs in the B slots until all finish or the loop
        reaches ``max_iters`` steps.  primers: B token lists;
        lead_sheet_bars: B lists of per-bar token lists.  With
        ``gpt2_tiers`` the GPT-2 cache walks the ladder; ``tier_resumes``
        counts the moves to a larger tier."""
        B = self.batch
        if len(primers) != B or len(lead_sheet_bars) != B:
            raise ValueError(f'generate takes exactly batch={B} jobs')
        jobs = self._prep_jobs(primers, lead_sheet_bars, max_bars)
        t0 = time.time()
        gen = self._generator(seed)
        tiers = self.tiers + [self.gpt2_cache_len] if self.tiers else [None]
        s = self._init_state(jobs, list(range(B))[self.rows],
                             cache_len=tiers[0])
        iters = self._lockstep(s, gen, 0)
        resumed = 0
        for tier in tiers[1:]:
            overflow = s['status'] == STATUS_OVERFLOW
            if not any_rows(self.mesh, overflow):
                break
            resumed += 1
            # unwritten positions are masked by the decode, so padding the
            # caches changes no logit
            for name, cache in s['state'].items():
                grow = tier - cache.shape[self._k_axis]
                pad = (0, 0, 0, 0, 0, grow) if self._k_axis == 2 else (0, grow)
                s['state'][name] = F.pad(cache, pad)
            s['status'] = torch.where(overflow, STATUS_RUNNING, s['status'])
            iters = self._lockstep(s, gen, iters)
        if 'counted' in s:        # steps since the last read (max_iters)
            self._poll(s)
        got = {k: gather_rows(self.mesh, s[k]) for k in (
            'out', 'out_len', 'status', 'bars', 'reanchors', 'rejects')}
        out, out_len, status = got['out'], got['out_len'], got['status']
        secs = time.time() - t0
        streams = [self._stream(out[b], out_len[b], status[b]) for b in range(B)]
        stats = {'seconds': secs, 'status': status.tolist(),
                 'bars': got['bars'].tolist(), 'events': out_len.tolist(),
                 'reanchors': got['reanchors'].tolist(),
                 'rejects': got['rejects'].tolist(), 'steps': iters,
                 'tier_resumes': resumed}
        return streams, stats

    @torch.no_grad()
    def serve(self, primers: Sequence[Sequence[int]],
              lead_sheet_bars: Sequence[List[List[int]]], *,
              seed: int = 0, max_bars: Optional[int] = None,
              ) -> Tuple[List[List[int]], dict]:
        """Continuous batching: N jobs stream through the B slots in chunks
        of at least ``serve_chunk_steps`` steps (``slots.SlotLoop._serve``).
        The GPT-2 cache ladder does not apply (refills interleave jobs at
        mixed clocks).  Returns (streams, stats) in submission order;
        ``stats`` carries the per-job fields of ``generate`` and the loop's
        ``wall_seconds``, ``chunks``, ``steps``, ``admitted_s`` and
        ``finished_s``."""
        N = len(primers)
        if len(lead_sheet_bars) != N:
            raise ValueError('one lead sheet per primer')
        jobs = (self._prep_jobs(primers, lead_sheet_bars, max_bars) if N
                else None)
        return self._serve(jobs, N, seed=seed,
                           chunk_steps=self.serve_chunk_steps,
                           fields=SERVE_FIELDS, result=self._stream)
