"""Batched stage-2 generation: B performances stepped together.

Port of the Performer branch of ``emo_disentanger_tpu/infer/stage2_batch.py``.
The Performer's decode state is the per-layer FAVOR+ (S, z) pair, with no
positional cache, so every batch element runs its own token stream with a
private position counter, and sampling and the per-bar teacher-forced
lead-sheet injection share one loop body:

* each element is either SAMPLING the full track or INJECTING the next
  lead-sheet bar from a precomputed token matrix;
* rejected samples (beat monotonicity, PAD, early EOS) leave that element's
  state and logits unchanged and resample, while other elements proceed;
  256 consecutive beat rejections mark the element STUCK, and a per-element
  step budget guards against runaways;
* every stream drops its final token, except a STUCK one.

The body is a Python loop over device tensors.  Elements that are not
running are frozen by the status masks (their state update is masked off),
so the host reads ``any(running)`` only every ``HOST_CHECK_STEPS`` steps;
the extra steps change nothing.  ``serve()`` streams N jobs through the B
slots, refilling every finished slot in one masked update that also zeroes
the slot's (S, z).

GPT-2 stage 2 is not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.vocab import Vocab
from ..models.performer import MusicPerformer
from ..ops.sampling import nucleus_sample
from ..utils.device import resolve_device
from .rules import build_rule_tables

STATUS_RUNNING = 0
STATUS_EOS = 2
STATUS_MAX = 3
STATUS_STUCK = 4
STATUS_DONE_BARS = 5
STATUS_IDLE = 6          # serve(): slot drained, no job to refill

MODE_SAMPLE = 0
MODE_INJECT = 1

# steps between host reads of the status; at most 32
HOST_CHECK_STEPS = 16

_JOB_FIELDS = ('inj_tokens', 'inj_segs', 'inj_len', 'primer', 'primer_len',
               'target_bars')
_COUNTERS = ('t', 'primer_pos', 'bars', 'inj_pos', 'cur_pos', 'failed',
             'rejects', 'esteps')


class Stage2BatchGenerator:
    """Whole-batch Performer generation on one device."""

    def __init__(self, model, vocab: Vocab, *, batch: int, temp: float = 1.1,
                 top_p: float = 0.99, max_events: int = 10000,
                 max_bar_tokens: int = 256, max_bars: int = 128,
                 serve_chunk_steps: int = 192,
                 omegas: Optional[torch.Tensor] = None,
                 gpt2_tiers: Optional[Sequence[int]] = None,
                 device: Union[str, torch.device] = 'cuda'):
        self.device = resolve_device(device)
        if not isinstance(model, MusicPerformer) or gpt2_tiers:
            raise NotImplementedError(
                'only the Performer stage 2 is ported; GPT-2 and gpt2_tiers '
                'are not yet')
        if omegas is None:
            raise ValueError('Performer decoding needs drawn omegas')
        if model.device != self.device or omegas.device != self.device:
            raise ValueError(f'model on {model.device} and omegas on '
                             f'{omegas.device}; expected {self.device}')
        self.model = model
        self.vocab = vocab
        self.batch = batch
        self.temp = temp
        self.top_p = top_p
        self.max_events = max_events
        self.max_bar_tokens = max_bar_tokens
        self.max_bars = max_bars
        self.serve_chunk_steps = serve_chunk_steps
        self.omegas = omegas.float().contiguous()
        self.max_iters = max_events * 2 + 8192
        tb = build_rule_tables(vocab)
        on_dev = lambda a: torch.as_tensor(a, device=self.device)
        self._is_beat = on_dev(tb.is_beat)
        self._beat_pos = on_dev(tb.beat_pos.astype(np.int64))
        self._is_pad = on_dev(tb.is_pad)
        self._is_eos = on_dev(tb.is_eos)
        self._is_lead = on_dev(tb.is_track_lead)
        self._ar = torch.arange(batch, device=self.device)

    # ---- the loop body ----

    def _step(self, s: Dict, gen: torch.Generator) -> None:
        """One decode step for every element, updating ``s`` in place."""
        ar = self._ar
        act = s['status'] == STATUS_RUNNING
        in_primer, mode = s['in_primer'], s['mode']

        # --- choose this step's token per element ---
        sampled = nucleus_sample(s['logits'], self.temp, self.top_p, gen)
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

        # --- the model runs for everyone; masked elements' state is frozen ---
        advance = act & ~reject
        new_logits, _ = self.model.decode_step_batchpos(
            token, seg, s['t'], self.omegas, s['state'], update_mask=advance)
        s['logits'] = torch.where(advance[:, None], new_logits, s['logits'])
        s['t'] = s['t'] + advance

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

        eos_final = sampling & advance & self._is_eos[token] & ~eos_early
        esteps = s['esteps'] + act
        status = torch.where(act & stuck, STATUS_STUCK, s['status'])
        status = torch.where(act & (esteps >= self.max_iters), STATUS_STUCK,
                             status)
        status = torch.where(act & eos_final, STATUS_EOS, status)
        status = torch.where(act & (s['out_len'] > self.max_events),
                             STATUS_MAX, status)
        status = torch.where(act & bar_done & ~more, STATUS_DONE_BARS, status)
        s['status'] = status
        s['esteps'] = esteps
        s['failed'] = failed
        s['rejects'] = s['rejects'] + reject

    def _running(self, s: Dict) -> torch.Tensor:
        return s['status'] == STATUS_RUNNING

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

    def _job_rows(self, jobs: Dict[str, np.ndarray], rows) -> Dict:
        r = np.asarray(rows)
        return {f: torch.from_numpy(jobs[f][r]).to(self.device)
                for f in _JOB_FIELDS}

    def _reset_slots(self, s: Dict, mask: np.ndarray, idle: np.ndarray,
                     rows: Dict) -> None:
        """One masked update that re-arms every slot in ``mask`` with its job
        from ``rows`` (B-shaped; unmasked rows ignored), zeroes those slots'
        (S, z) (the masked update ADDS to them), and idles the slots in
        ``idle``."""
        B = self.batch
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
        s['status'] = torch.where(m, STATUS_RUNNING, torch.where(
            torch.from_numpy(idle).to(self.device), STATUS_IDLE, s['status']))
        keep = (~m).float()
        for a in s['state'].values():          # [n_layer, B, ...]
            a.mul_(keep.reshape((1, B) + (1,) * (a.dim() - 2)))

    def _init_state(self, jobs: Dict[str, np.ndarray], rows) -> Dict:
        B, dev = self.batch, self.device
        zl = lambda *shape: torch.zeros(shape, dtype=torch.long, device=dev)
        s = {'state': self.model.init_decode_state(B),
             'out': zl(B, self.max_events + 8),
             'out_segs': zl(B, self.max_events + 8),
             'out_len': zl(B), 'mode': zl(B), 'status': zl(B),
             'in_primer': torch.zeros(B, dtype=torch.bool, device=dev),
             'logits': torch.zeros(B, self.vocab.size, dtype=torch.float32,
                                   device=dev)}
        s.update({f: zl(B) for f in _COUNTERS})
        first = self._job_rows(jobs, rows)
        s.update({f: torch.zeros_like(t) for f, t in first.items()})
        self._reset_slots(s, np.ones(B, bool), np.zeros(B, bool), first)
        return s

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    @staticmethod
    def _stream(out_row: np.ndarray, n: int, status: int) -> List[int]:
        """A stuck model returns its full partial stream; every other
        termination drops the final token, as the reference does."""
        toks = out_row[:n].tolist()
        return toks if status == STATUS_STUCK else toks[:-1]

    # ---- generate / serve ----

    @torch.no_grad()
    def generate(self, primers: Sequence[Sequence[int]],
                 lead_sheet_bars: Sequence[List[List[int]]], *,
                 seed: int = 0, max_bars: Optional[int] = None,
                 ) -> Tuple[List[List[int]], dict]:
        """Lockstep: B jobs in the B slots until all finish or the loop
        reaches ``max_iters`` steps.  primers: B token lists;
        lead_sheet_bars: B lists of per-bar token lists."""
        B = self.batch
        if len(primers) != B or len(lead_sheet_bars) != B:
            raise ValueError(f'generate takes exactly batch={B} jobs')
        jobs = self._prep_jobs(primers, lead_sheet_bars, max_bars)
        t0 = time.time()
        gen = self._generator(seed)
        s = self._init_state(jobs, list(range(B)))
        iters = 0
        while iters < self.max_iters and bool(self._running(s).any()):
            for _ in range(min(HOST_CHECK_STEPS, self.max_iters - iters)):
                self._step(s, gen)
                iters += 1
        out = s['out'].cpu().numpy()
        out_len = s['out_len'].cpu().numpy()
        status = s['status'].cpu().numpy()
        secs = time.time() - t0
        streams = [self._stream(out[b], out_len[b], status[b]) for b in range(B)]
        stats = {'seconds': secs, 'status': status.tolist(),
                 'bars': s['bars'].cpu().tolist(), 'events': out_len.tolist(),
                 'rejects': s['rejects'].cpu().tolist(), 'steps': iters}
        return streams, stats

    def _run_chunk(self, s: Dict, gen: torch.Generator) -> int:
        """Run until a slot finishes and at least ``serve_chunk_steps`` steps
        have passed, or nothing is left running (checked every
        ``HOST_CHECK_STEPS`` steps); returns the steps run."""
        entry = self._running(s)
        i = 0
        while True:
            run = self._running(s)
            if not bool(run.any()) or (i >= self.serve_chunk_steps
                                       and not bool((run == entry).all())):
                return i
            for _ in range(HOST_CHECK_STEPS):
                self._step(s, gen)
            i += HOST_CHECK_STEPS

    @torch.no_grad()
    def serve(self, primers: Sequence[Sequence[int]],
              lead_sheet_bars: Sequence[List[List[int]]], *,
              seed: int = 0, max_bars: Optional[int] = None,
              ) -> Tuple[List[List[int]], dict]:
        """Continuous batching: N jobs stream through the B slots; a finished
        slot is harvested and re-armed with the next queued job at the end
        of the chunk it finished in.  Returns (streams, stats) in submission
        order; ``stats`` carries the per-job fields of ``generate``,
        ``wall_seconds``, ``chunks`` (host refill round trips) and ``steps``
        (loop steps over all slots)."""
        N = len(primers)
        if len(lead_sheet_bars) != N:
            raise ValueError('one lead sheet per primer')
        B = self.batch
        empty = {'seconds': 0.0, 'wall_seconds': 0.0, 'chunks': 0, 'steps': 0,
                 'status': [], 'bars': [], 'events': [], 'rejects': []}
        if N == 0:
            return [], empty
        jobs = self._prep_jobs(primers, lead_sheet_bars, max_bars)
        t0 = time.time()
        gen = self._generator(seed)
        first = min(B, N)
        s = self._init_state(jobs, list(range(first)) + [0] * (B - first))
        slot_job: List[Optional[int]] = list(range(first)) + [None] * (B - first)
        if first < B:
            idle0 = np.zeros(B, bool)
            idle0[first:] = True
            self._reset_slots(s, np.zeros(B, bool), idle0,
                              self._job_rows(jobs, [0] * B))
        next_job = first
        streams: List[Optional[List[int]]] = [None] * N
        per_job = {k: [0] * N for k in ('status', 'bars', 'events', 'rejects')}
        chunks = steps = 0
        while bool(self._running(s).any()):
            steps += self._run_chunk(s, gen)
            chunks += 1
            status = s['status'].cpu().numpy()
            finished = [b for b in range(B) if slot_job[b] is not None
                        and status[b] not in (STATUS_RUNNING, STATUS_IDLE)]
            if not finished:
                continue
            out = s['out'].cpu().numpy()
            out_len = s['out_len'].cpu().numpy()
            bars = s['bars'].cpu().numpy()
            rejects = s['rejects'].cpu().numpy()
            for b in finished:
                j = slot_job[b]
                streams[j] = self._stream(out[b], out_len[b], status[b])
                per_job['status'][j] = int(status[b])
                per_job['bars'][j] = int(bars[b])
                per_job['events'][j] = int(out_len[b])
                per_job['rejects'][j] = int(rejects[b])
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
            self._reset_slots(s, mask, idle, self._job_rows(jobs, rows))
        secs = time.time() - t0
        return streams, {'seconds': secs, 'wall_seconds': secs,
                         'chunks': chunks, 'steps': steps, **per_job}
