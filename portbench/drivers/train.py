"""The training driver: the program's stage-2 training step, driven as
``train_stage2.run`` drives it, over a corpus written from the seed.

A step fetches the next batch from the program's ``Stage2Dataset``, moves
it to the device, redraws the Performer's features with the configured
probability (the program's ``draw_omegas``), runs the step that
``make_train_step`` made, and reads its loss.  Set-up builds the one step
object and drives it through its first ``check_updates`` updates, which
warm every shape; the window continues with that same object.  The
reference follows those first updates after the window (``check``).

End to end: ``train_tokens_per_s``, the B x L input tokens of every step
completed in the window over the window's wall, and ``train_step_p95_ms``,
the 95th percentile of every step's wall (fetch to loss read).
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench import common, inputs, traffic
from portbench.reference import data as ref_data
from portbench.reference import models as ref_models
from portbench.reference import train as ref_train

COMPUTE = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


class Driver:
    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 fault: Optional[str] = None, program: bool = True):
        """``program=False`` writes the inputs only (the reference's own
        readings need no program)."""
        from emo_disentanger_tpu_torch.core.vocab import Vocab
        from emo_disentanger_tpu_torch.data.datasets import Stage2Dataset
        from emo_disentanger_tpu_torch.train import trainer

        self.cfg, self.cell, self.device = cfg, cell, torch.device(device)
        t = cell['traffic']
        self.B, self.L = t['batch'], t['seq_len']
        opt = cfg['training']
        self.accum = opt['accum_steps']
        self.s = common.seeds(seed, 8)
        self.performer = cfg['kind'] == 'performer'
        self.tmp = tempfile.mkdtemp(prefix='portbench-corpus-')
        self.names = traffic.write_corpus(self.tmp, self.s[0], t['corpus_pieces'],
                                          t['corpus_bars'])
        self.events_dir = os.path.join(self.tmp, 'events')
        self.e2w, w2e = traffic.dictionary()
        self.vocab = Vocab(self.e2w, w2e)
        self.V = self.vocab.size
        if not program:
            return
        dset = Stage2Dataset(self.events_dir, self.vocab, pieces=self.names,
                             model_dec_seqlen=self.L, seed=self.s[1])

        def endless():
            while True:
                yield from dset.batches(self.B, shuffle=True)
        self.batches = endless()

        self.model = _build_model(cfg, self.V, self.device,
                                  COMPUTE[opt['compute_dtype']])
        self.weights = inputs.make_weights(cfg, self.V, self.s[2], self.device)
        self.model.load_state_dict(self.weights, strict=True)
        self.omegas = (inputs.initial_omegas(cfg, self.s[3], self.device)
                       if self.performer else None)
        self.optimizer = trainer.make_optimizer(
            self.model.parameters(), trainer.OptimizerConfig(
                max_lr=opt['lr'], min_lr=opt['eta_min'],
                warmup_steps=opt['warmup_steps'], lr_decay_steps=opt['T_max'],
                clip_norm=opt['clip_norm'], accum_steps=self.accum))
        loss_fn = (trainer.stage2_performer_loss_fn if self.performer
                   else trainer.stage2_gpt2_loss_fn)(self.model, self.vocab.pad_id)
        if fault == 'half_batch':
            half = self.B // 2
            whole = loss_fn
            loss_fn = lambda b, x: whole({k: v[:half] for k, v in b.items()}, x)
        if fault == 'frozen':
            self.optimizer.adam.step = lambda *a, **k: None
        self.step = trainer.make_train_step(loss_fn, self.model, self.optimizer)
        self.to_device = lambda b: trainer.batch_to_device(
            trainer.neutralize_pad_rows(b, self.B, self.vocab.pad_id), self.device)
        self.omega_gen = torch.Generator().manual_seed(self.s[4])
        self.host_rng = np.random.RandomState(self.s[5])
        if self.performer:                 # the host's first QR loads LAPACK
            self.model.draw_omegas(torch.Generator().manual_seed(0))

        # the checked updates: they go through the window's own call
        torch.manual_seed(self.s[6])        # the dropout masks
        self.losses = []
        self.first_grad = None
        for i in range(self.cell['check']['updates'] * self.accum):
            self.losses.append(self.one_step()[0])
            if self.first_grad is None and (i + 1) == self.accum:
                self.first_grad = self._adam_grads()
        self.change = {n: (p.detach() - self.weights[n]).clone()
                       for n, p in self.model.named_parameters()}
        _sync(self.device)

    def _adam_grads(self) -> Dict[str, torch.Tensor]:
        """The first update's gradient as Adam got it: its first moment
        after one update over (1 - b1)."""
        state = self.optimizer.adam.state
        return {n: (state[p]['exp_avg'] / 0.1 if p in state and state[p]
                    else torch.zeros_like(p)).clone()
                for n, p in self.model.named_parameters()}

    def one_step(self):
        """One step as ``train_stage2.run`` takes it: (loss, wall seconds)."""
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function('portbench.fetch_batch'):
            batch = self.to_device(next(self.batches))
        if self.performer and self.host_rng.random() <= self.cfg['training']['feat_redraw_prob']:
            with record_function('portbench.redraw_features'):
                self.omegas = self.model.draw_omegas(self.omega_gen)
        with record_function('portbench.train_step'):
            loss, _ = self.step(batch, {'omegas': self.omegas} if self.performer else {})
        with record_function('portbench.loss_read'):
            loss = float(loss)
        return loss, time.perf_counter() - t0

    def run_window(self, seconds: float, trace=None):
        walls, losses = [], []
        t0 = time.perf_counter()
        while True:
            if trace is not None:
                trace.step()
            loss, wall = self.one_step()
            walls.append(wall)
            losses.append(loss)
            if _over(t0, seconds, trace):
                break
        window = time.perf_counter() - t0
        self.attempted = len(walls)
        self.failed = sum(not math.isfinite(x) for x in losses)
        tokens = self.B * self.L * len(walls)
        return {'train_tokens_per_s': (tokens / window, 'tokens/s'),
                'train_step_p95_ms': (1e3 * common.p95(walls), 'ms')}

    def counts(self) -> dict:
        return {'batch': self.B, 'seq_len': self.L, 'vocab': self.V}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        keep = {n: self.first_grad[n].detach() for n in self.first_grad}
        self.program = {'losses': self.losses, 'first_grad': keep,
                        'change': self.change}
        for name in ('model', 'optimizer', 'step', 'batches', 'omegas',
                     'to_device', 'weights'):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, quant=ref_models._ident) -> dict:
        """The plain model's first updates from the same inputs."""
        cfg = self.cfg
        n = self.cell['check']['updates'] * self.accum
        stream = ref_data.batches(self.events_dir, self.names, self.e2w,
                                  self.L, self.B, self.s[1])
        batches = [{k: torch.as_tensor(v, device=self.device)
                    for k, v in next(stream).items()} for _ in range(n)]
        omegas = []
        if self.performer:
            om = inputs.initial_omegas(cfg, self.s[3], self.device)
            gen = torch.Generator().manual_seed(self.s[4])
            rng = np.random.RandomState(self.s[5])
            Dh = cfg['d_model'] // cfg['n_head']
            for _ in range(n):
                if rng.random() <= cfg['training']['feat_redraw_prob']:
                    om = torch.stack([ref_models.draw_features(
                        Dh, cfg['n_features'], gen)
                        for _ in range(cfg['n_layer'])]).to(self.device)
                omegas.append(om)
        P0 = inputs.make_weights(cfg, self.V, self.s[2], self.device)
        torch.manual_seed(self.s[6])
        shapes = ref_models.drop_shapes(cfg, self.B, self.L)
        dtype = COMPUTE[cfg['training']['compute_dtype']]
        replay = lambda i: ref_train.DropoutReplay(shapes, cfg['dropout'],
                                                   dtype, self.device)
        with _no_tf32():
            return ref_train.follow(
                P0, cfg, batches, (lambda i: omegas[i] if omegas else None),
                replay, self.vocab.pad_id, self.cell['check']['rows'], quant)

    def check(self):
        """(correct, the numbers compared with their limits)."""
        got = ref_train.compare(self.program, self.reference())
        for k in sorted(set(got) - set(self.cell['limits'])):
            print(f'read, not compared: {k} {got[k]!r}', file=sys.stderr)
        limits = self.cell['limits']
        compared = {k: {'value': got[k], 'limit': limits[k]} for k in limits}
        return all(v['value'] <= v['limit'] for v in compared.values()), compared

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def _build_model(cfg: dict, vocab: int, device, compute_dtype):
    from emo_disentanger_tpu_torch.models.gpt2 import MusicGPT2
    from emo_disentanger_tpu_torch.models.performer import MusicPerformer
    common_kw = dict(n_token=vocab, n_layer=cfg['n_layer'], n_head=cfg['n_head'],
                     d_model=cfg['d_model'], d_ff=cfg['d_ff'],
                     d_embed=cfg['d_embed'], use_segment_emb=cfg['use_segemb'],
                     n_segment_types=cfg['n_segment_types'],
                     dropout=cfg['dropout'], compute_dtype=compute_dtype,
                     device=device)
    if cfg['kind'] == 'performer':
        return MusicPerformer(favor_dims=cfg['n_features'], **common_kw)
    return MusicGPT2(**common_kw)


class _no_tf32:
    """float32 products in float32: TF32 off for the reference."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _over(t0: float, seconds: float, trace) -> bool:
    """Whether the window has run its length (and every traced step)."""
    return (time.perf_counter() - t0 >= seconds
            and (trace is None or trace.complete))


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
