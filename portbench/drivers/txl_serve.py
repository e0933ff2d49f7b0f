"""The stage-1 generation driver: the program's batched lead-sheet generator
(``Stage1BatchGenerator.serve``, the entry point behind ``infer-stage1
--batch N --serve``) over a queue of songs drawn from the seed, call after
call, in whole calls, for about the window's length.

Each call submits ``queue`` songs, several times the slots, so that the
generator refills each slot whose song has finished with the next queued
song while the others run on, and drains only at the queue's end.  Every
slot decodes greedily (``top_p`` 0); the primers hold their key, so the
generator's sampled key step never comes, and a song's every token after
its primer is the model's choice, which the check compares with the plain
float32 model.  The cache layout is the program's default.

End to end: ``gen_events_per_s``, the events every call wrote to its songs
after the primers, over the wall of all the calls.

A traced run makes one call and records a fixed slice of its steps, each
step marked where the generator calls the model's public decode entry
(``decode_step_pe``, once a step).  The per-layer metrics read the
program's own spans and counters (``utils.profiling``).
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Optional

import numpy as np
import torch

from portbench import common, inputs_txl, traffic_txl
from portbench.drivers import serve
from portbench.reference import models as ref_models
from portbench.reference import txl as ref_txl

SERVED = serve.SERVED
# the generator's final statuses that are failures (``infer/stage1.py``)
STUCK, OVERFLOW = 2, 3


class Driver:
    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 fault: Optional[str] = None):
        from emo_disentanger_tpu_torch.core.vocab import Vocab
        from emo_disentanger_tpu_torch.infer.stage1_batch import Stage1BatchGenerator
        from emo_disentanger_tpu_torch.models.txl import PlainTransformer
        from emo_disentanger_tpu_torch.utils.precision import cast_params

        self.cfg, self.cell, self.device = cfg, cell, torch.device(device)
        t = self.t = cell['traffic']
        self.s = common.seeds(seed, 8)
        self.e2w, w2e = traffic_txl.dictionary()
        self.vocab = Vocab(self.e2w, w2e)
        self.V = self.vocab.size
        dtype = SERVED[cfg['serving']['weights_dtype']]
        self.model = PlainTransformer(
            self.V, d_embed=cfg['d_embed'], n_layer=cfg['n_layer'],
            n_head=cfg['n_head'], d_model=cfg['d_model'], d_ff=cfg['d_ff'],
            dropout=cfg['dropout'], pre_lnorm=cfg['pre_lnorm'],
            mem_len=cfg['mem_len'], pad_id=self.vocab.pad_id,
            device=self.device)
        self.model.load_state_dict(self.reference_weights(), strict=True)
        self.model.eval()
        cast_params(self.model, dtype)
        if t['top_p'] != 0:
            raise ValueError('the check compares greedy songs only: top_p 0')
        self.gen = Stage1BatchGenerator(
            self.model, self.vocab, batch=t['slots'], temp=t['temperature'],
            top_p=t['top_p'], max_events=t['max_events'],
            reject_slack=t['reject_slack'],
            cache_layout=cfg['serving']['cache_layout'], device=self.device)
        if fault == 'token':
            self._plant_token_fault()
        if fault == 'frozen':
            self._plant_frozen_cache()
        self.rng = np.random.RandomState(self.s[2])
        self.calls = 0
        # warm-up: one call of the same slots, two bars a song, twice as
        # many songs as slots so that the refill runs too
        emotions, primers, _ = traffic_txl.jobs(
            2 * t['slots'], 2, 2, np.random.RandomState(self.s[3]))
        self.gen.serve(emotions, seed=self.s[4], target_bars=[2] * len(primers),
                       primers=primers)
        if self.device.type == 'cuda':
            torch.cuda.synchronize()

    def _plant_token_fault(self) -> None:
        """A fault for the tests: every chosen token moved to the next id."""
        from emo_disentanger_tpu_torch.infer import stage1
        real = stage1.nucleus_sample
        V = self.V
        stage1.nucleus_sample = lambda *a, **k: (real(*a, **k) + 1) % (V - 1)
        self._restore = lambda: setattr(stage1, 'nucleus_sample', real)

    def _plant_frozen_cache(self) -> None:
        """A fault for the tests: the decode never writes a cache row (each
        step writes into a copy of the cache)."""
        real = self.model.decode_step_pe

        def frozen(token, t, cache, *args, **kw):
            return real(token, t, {k: v.clone() for k, v in cache.items()},
                        *args, **kw)
        self.model.decode_step_pe = frozen

    def run_window(self, seconds: float, trace=None):
        """Whole calls until the window has run its length, or until the
        time left is under half a call; a traced run makes one call."""
        self.songs, self.events = [], 0
        self.attempted = self.failed = self.rejected = 0
        if trace is not None:
            self._mark_steps(trace)
        lo, hi = self.t['bars']
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            emotions, primers, bars = traffic_txl.jobs(
                self.t['queue'], lo, hi, self.rng, self.t.get('same_sizes', False))
            songs, stats = self.gen.serve(emotions, seed=self.s[5] + self.calls,
                                          target_bars=bars, primers=primers)
            self.calls += 1
            written = sum(e - len(p) for e, p in zip(stats['events'], primers))
            self.events += written
            print(f'call {self.calls}: {stats["seconds"]:.3f} s, '
                  f'{stats["steps"]} steps, {stats["chunks"]} chunks, '
                  f'{written} events', file=sys.stderr)
            self._tally(songs, stats, primers, bars)
            now = time.perf_counter()
            if trace is not None:
                break
            if seconds - (now - t0) < (now - c0) / 2:
                break
        window = time.perf_counter() - t0
        return {'gen_events_per_s': (self.events / window, 'events/s')}

    def _tally(self, songs, stats: dict, primers, bars) -> None:
        """The call's songs for the check, its failures (stuck, overflowed,
        or ended short of the target bars) and its rejected draws."""
        for song, p, tb, st, b, r in zip(songs, primers, bars, stats['status'],
                                         stats['bars'], stats['rejects']):
            self.attempted += 1
            self.failed += st in (STUCK, OVERFLOW) or b < tb
            self.rejected += r
            if song is not None:
                self.songs.append({'stream': [self.e2w[e] for e in song],
                                   'primer_len': len(p)})

    def _mark_steps(self, trace) -> None:
        """Mark each decode step for the trace as the generator enters the
        model's decode, once a step."""
        real = self.model.decode_step_pe

        def step(*args, **kw):
            trace.step()
            return real(*args, **kw)
        self.model.decode_step_pe = step

    def counts(self) -> dict:
        """The readers take the steps, slots and cache rows from the
        program's own counters; the vocabulary sizes the head."""
        return {'vocab': self.V}

    def release(self) -> None:
        if hasattr(self, '_restore'):
            self._restore()
        for name in ('gen', 'model'):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # the songs the check reads: the window's longest, and others drawn
    # from the seed, as the stage-2 driver picks them
    sample = serve.Driver.sample

    def reference_weights(self):
        return inputs_txl.make_weights(
            self.cfg, self.V, self.s[0], self.device,
            grammar=self.cfg['head_grammar'], e2w=self.e2w,
            served_dtype=SERVED[self.cfg['serving']['weights_dtype']])

    def gaps(self, quant=ref_models._ident, control=False) -> np.ndarray:
        from portbench.drivers.train import _no_tf32
        if not self.songs:
            return np.zeros(0)
        with _no_tf32():
            return ref_txl.chosen_gaps(self.reference_weights(), self.cfg,
                                       self.sample(), quant, control,
                                       self.device)

    def check(self):
        limits = self.cell['limits']
        gaps = self.gaps()
        got = {'gap': float(gaps.max()) if gaps.size else float('inf'),
               'unfinished': float(self.failed),
               'rejected': float(self.rejected)}
        compared = {k: {'value': got[k], 'limit': limits[k]} for k in limits}
        return all(v['value'] <= v['limit'] for v in compared.values()), compared

    def close(self) -> None:
        pass
