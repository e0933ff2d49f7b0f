"""The generation driver: the program's batched stage-2 generator
(``Stage2BatchGenerator.serve``) over a queue of lead sheets drawn from the
seed, call after call, in whole calls, for about the window's length.

Each call submits ``queue`` songs, several times the slots, so that the
generator refills each slot whose song has finished with the next queued
song while the others run on, and drains only at the queue's end.  Every
slot decodes greedily (``top_p`` 0, passed as a per-slot tensor, so the
nucleus sampler runs its whole sort, sums and draw for every row): the
generator sets greediness by slot, not by song, so in a queue only an
all-greedy call tells which songs the check may compare with the plain
model.

End to end: ``gen_events_per_s``, the events every call wrote to its song
streams after the primers (injected lead-sheet events and chosen ones),
over the wall of all the calls.

A traced run makes one call and records a fixed slice of its steps, each
step marked where the generator calls the model's public decode entry
(``decode_step_batchpos``, once a step).  The counts the per-layer metrics
take (steps, slot-steps, cache rows) are the call's, a step on average,
from ``serve``'s returned stats (its steps, each song's events and
rejected steps), never from the generator's internals.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Optional

import numpy as np
import torch

from portbench import common, inputs, traffic
from portbench.reference import models as ref_models
from portbench.reference import serve as ref_serve

SERVED = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


class Driver:
    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 fault: Optional[str] = None):
        from emo_disentanger_tpu_torch.core.vocab import Vocab
        from emo_disentanger_tpu_torch.infer.stage2_batch import Stage2BatchGenerator
        from emo_disentanger_tpu_torch.utils.precision import cast_params
        from portbench.drivers.train import _build_model

        self.cfg, self.cell, self.device = cfg, cell, torch.device(device)
        t = self.t = cell['traffic']
        self.s = common.seeds(seed, 8)
        self.e2w, w2e = traffic.dictionary()
        self.vocab = Vocab(self.e2w, w2e)
        self.V = self.vocab.size
        dtype = SERVED[cfg['serving']['weights_dtype']]
        self.model = _build_model(cfg, self.V, self.device, None)
        self.weights = inputs.make_weights(
            cfg, self.V, self.s[0], self.device, grammar=cfg['head_grammar'],
            e2w=self.e2w, served_dtype=dtype)
        self.model.load_state_dict(self.weights, strict=True)
        self.model.eval()
        cast_params(self.model, dtype)
        self.omegas = (inputs.initial_omegas(cfg, self.s[1], self.device)
                       if cfg['kind'] == 'performer' else None)
        slots = t['slots']
        if t['top_p'] != 0:
            raise ValueError('the check compares greedy songs only: top_p 0')
        top_p = torch.full((slots,), float(t['top_p']), device=self.device)
        kw = dict(batch=slots, temp=t['temperature'], top_p=top_p,
                  max_events=t['max_events'], omegas=self.omegas,
                  state_layout=cfg['serving'].get('state_layout'),
                  cache_layout=cfg['serving'].get('cache_layout'),
                  device=self.device)
        if cfg['kind'] == 'gpt2':
            kw.update(gpt2_cache_len=t['cache_len'], gpt2_window=t['window'],
                      reanchor_margin=t['reanchor_margin'])
        self.gen = Stage2BatchGenerator(self.model, self.vocab, **kw)
        if fault == 'token':
            self._plant_token_fault()
        if fault == 'frozen':
            self._plant_frozen_state()
        self.rng = np.random.RandomState(self.s[2])
        self.calls = 0
        # warm-up: one call of the same slots, a bar a song, twice as many
        # songs as slots so that the refill runs too
        warm = np.random.RandomState(self.s[3])
        primers, sheets = traffic.jobs(self.e2w, 2 * slots, 1, 1, warm)
        self.gen.serve(primers, sheets, seed=self.s[4])
        if self.device.type == 'cuda':
            torch.cuda.synchronize()

    def _plant_token_fault(self) -> None:
        """A fault for the tests: every chosen token moved to the next id."""
        from emo_disentanger_tpu_torch.infer import stage2_batch
        real = stage2_batch.nucleus_sample
        V = self.V
        stage2_batch.nucleus_sample = lambda *a, **k: (real(*a, **k) + 1) % (V - 1)
        self._restore = lambda: setattr(stage2_batch, 'nucleus_sample', real)

    def _plant_frozen_state(self) -> None:
        """A fault for the tests: the decode never updates its state."""
        real = self.model.decode_step_batchpos

        def frozen(token, seg, t, *args, **kw):
            args = list(args)
            for i, a in enumerate(args):
                if isinstance(a, dict):
                    args[i] = {k: v.clone() for k, v in a.items()}
            return real(token, seg, t, *args, **kw)
        self.model.decode_step_batchpos = frozen

    def run_window(self, seconds: float, trace=None):
        """Whole calls until the window has run its length, or until the
        time left is under half a call; a traced run makes one call."""
        self.songs, self.events = [], 0
        self.steps = self.slot_steps = self.live_rows = 0
        self.statuses = []
        if trace is not None:
            self._mark_steps(trace)
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            primers, sheets = traffic.jobs(
                self.e2w, self.t['queue'], self.t['bars'][0], self.t['bars'][1],
                self.rng, self.t.get('same_sizes', False))
            streams, stats = self.gen.serve(primers, sheets,
                                            seed=self.s[5] + self.calls)
            self.calls += 1
            written = sum(e - len(p) - 1 for e, p in zip(stats['events'], primers))
            self.events += written
            print(f'call {self.calls}: {stats["wall_seconds"]:.3f} s, '
                  f'{stats["steps"]} steps, {stats["chunks"]} chunks, '
                  f'{written} events', file=sys.stderr)
            self._count(stats)
            self.statuses += stats['status']
            self.songs += [{'stream': st, 'primer_len': len(p) + 1, 'bars': b}
                           for st, p, b in zip(streams, primers, sheets)]
            now = time.perf_counter()
            if trace is not None:
                break
            if seconds - (now - t0) < (now - c0) / 2:
                break
        window = time.perf_counter() - t0
        self.attempted = len(self.statuses)
        self.failed = sum(s in (0, 6, 7) for s in self.statuses)
        return {'gen_events_per_s': (self.events / window, 'events/s')}

    def _mark_steps(self, trace) -> None:
        """Mark each decode step for the trace as the generator enters the
        model's decode, once a step."""
        real = self.model.decode_step_batchpos

        def step(*args, **kw):
            trace.step()
            return real(*args, **kw)
        self.model.decode_step_batchpos = step

    def _count(self, stats: dict) -> None:
        """The call's loop steps, its songs' slot-steps (each song's clock
        advances once a step it runs, to its stream's length, and a rejected
        step runs the model without advancing it), and the cache rows up to
        each running song's clock, summed over its steps (a rejected step's
        rows left out; the grammar leaves none)."""
        self.steps += stats['steps']
        for n, r in zip(stats['events'], stats['rejects']):
            self.slot_steps += n + r
            self.live_rows += n * (n + 1) // 2

    def counts(self) -> dict:
        return {'steps': self.steps, 'slot_steps': self.slot_steps,
                'live_rows': self.live_rows, 'vocab': self.V}

    def release(self) -> None:
        if hasattr(self, '_restore'):
            self._restore()
        for name in ('gen', 'model', 'weights'):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def sample(self):
        """The songs the check reads: the longest song of the window, and
        ``check_songs - 1`` others drawn from the seed."""
        lens = [len(s['stream']) for s in self.songs]
        longest = int(np.argmax(lens))
        rest = [i for i in range(len(self.songs)) if i != longest]
        rng = np.random.RandomState(self.s[6])
        k = min(self.cell['check']['songs'] - 1, len(rest))
        return [self.songs[longest]] + [self.songs[i] for i in
                                        rng.choice(rest, size=k, replace=False)]

    def reference_weights(self):
        return inputs.make_weights(
            self.cfg, self.V, self.s[0], self.device,
            grammar=self.cfg['head_grammar'], e2w=self.e2w,
            served_dtype=SERVED[self.cfg['serving']['weights_dtype']])

    def gaps(self, quant=ref_models._ident, control=False) -> np.ndarray:
        from portbench.drivers.train import _no_tf32
        P = self.reference_weights()
        omegas = (inputs.initial_omegas(self.cfg, self.s[1], self.device)
                  if self.cfg['kind'] == 'performer' else None)
        with _no_tf32():
            return ref_serve.chosen_gaps(P, self.cfg, self.sample(), self.e2w,
                                         omegas, quant, control, self.device)

    def check(self):
        limits = self.cell['limits']
        try:
            gaps = self.gaps()
            got = {'gap': float(gaps.max()) if gaps.size else float('inf'),
                   'unfinished': float(self.failed)}
        except ValueError as err:          # a stream the lead sheet disowns
            print(f'check: {err}', flush=True)
            got = {'gap': float('inf'), 'unfinished': float(self.failed)}
        compared = {k: {'value': got[k], 'limit': limits[k]} for k in limits}
        return all(v['value'] <= v['limit'] for v in compared.values()), compared

    def close(self) -> None:
        pass
