"""Trainer for both stages, on one device or over a mesh (port of
``emo_disentanger_tpu/train/trainer.py``).

Adam with the warmup + cosine LR schedule behind a global-norm clip at 0.5,
optional gradient accumulation, and the total/chord/melody/others accuracy
sums of the reference's ``compute_accuracy``
(``stage1_compose/train.py:179-188``).  The JAX package's optimizer is an
optax chain; :class:`Optimizer` keeps its semantics step for step:

* ``clip_by_global_norm(clip_norm)`` before Adam: gradients are scaled by
  clip_norm / ||g|| when the global norm ||g|| is at least clip_norm;
* ``adam(schedule)``: b1 0.9, b2 0.999, eps 1e-8, and the k-th update
  (k = 0 first) uses the learning rate schedule(k);
* ``MultiSteps(every_k_schedule=accum_steps)``: the mean of k micro-batch
  gradients is clipped once, then one Adam step and one schedule step are
  taken per k micro-batches; the parameters do not move in between.

Over a mesh (``parallel.mesh``; the steps take ``mesh=``), each rank holds
its rows of the global batch and the step computes what JAX's jitted step
computes over the whole batch:

* the loss is the masked mean over the GLOBAL batch: the count of non-PAD
  targets is all-reduced over the data axes ('dcn', 'dp') before the
  backward, and each rank back-propagates its local mean times its share
  of the count (local sum / global count).  Ranks hold different counts
  whenever a short batch's PAD rows (``neutralize_pad_rows``) fall on
  some of them, so averaging per-rank means would be wrong;
* the gradients are all-reduced with SUM over the data axes, in one flat
  buffer, on the micro-batch that updates (accumulation stays local);
* the global-norm clip runs on the reduced gradient; under tensor
  parallelism the squared norms of sharded parameters are summed over tp
  and each replicated parameter counts once;
* the loss returned and the accuracy sums are the global ones.

A mesh of one runs these collectives on one rank, where they change no
bit: its parameters equal the ``mesh=None`` step's bit for bit.  The
Performer's omegas are inputs, drawn from identically seeded generators on
every rank; the segmented step's XL memories are per sample and stay
local.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.txl import masked_cross_entropy, update_mems_varlen
from ..parallel.mesh import data_group, data_rank, tp_group, tp_size
from .schedule import warmup_cosine


@dataclass(frozen=True)
class OptimizerConfig:
    max_lr: float = 1e-4
    min_lr: float = 1e-5
    warmup_steps: int = 200
    lr_decay_steps: int = 500_000
    clip_norm: float = 0.5
    accum_steps: int = 1


class Optimizer:
    """Adam behind a global-norm clip, stepped by the schedule, with
    ``accum_steps``-fold gradient accumulation (see the module docstring).
    Call :meth:`step` after every micro-batch's ``backward()``."""

    def __init__(self, params: Iterable[nn.Parameter], cfg: OptimizerConfig):
        self.cfg = cfg
        self.params = [p for p in params if p.requires_grad]
        self.schedule = warmup_cosine(cfg.max_lr, cfg.min_lr, cfg.warmup_steps,
                                      cfg.lr_decay_steps)
        self.adam = torch.optim.Adam(self.params, lr=self.schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)
        self.updates = 0          # Adam steps taken
        self.micro = 0            # micro-batches accumulated since the last
        self.tp_group = None      # set by a train step over a tp mesh

    @property
    def updates_next(self) -> bool:
        """Whether the next :meth:`step` updates the parameters."""
        return self.micro + 1 >= self.cfg.accum_steps

    def _global_norm(self, live) -> torch.Tensor:
        """||g|| over the parameters ``live`` (those with a gradient); under
        tensor parallelism the sharded ones' squares are summed over tp."""
        norms = [torch.linalg.vector_norm(p.grad) for p in live]
        if self.tp_group is None:
            return torch.linalg.vector_norm(torch.stack(norms))
        sq = lambda sharded: sum(
            (n * n for p, n in zip(live, norms)
             if getattr(p, 'tp_sharded', False) == sharded),
            norms[0].new_zeros(()))
        sharded = sq(True)
        dist.all_reduce(sharded, group=self.tp_group)
        return torch.sqrt(sharded + sq(False))

    def step(self) -> bool:
        """Count one micro-batch; on every ``accum_steps``-th, update the
        parameters and clear the gradients.  Returns whether it updated."""
        self.micro += 1
        k = self.cfg.accum_steps
        if self.micro < k:
            return False
        live = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in live]
        norm = self._global_norm(live) / k
        clip = torch.as_tensor(self.cfg.clip_norm, dtype=norm.dtype,
                               device=norm.device)
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm) / k
        for g in grads:
            g.mul_(scale)
        for group in self.adam.param_groups:
            group['lr'] = self.schedule(self.updates)
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.updates += 1
        self.micro = 0
        return True

    def state_dict(self) -> dict:
        return {'adam': self.adam.state_dict(), 'updates': self.updates,
                'micro': self.micro}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state['adam'])
        self.updates = int(state['updates'])
        self.micro = int(state['micro'])


def make_optimizer(params: Iterable[nn.Parameter],
                   cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(params, cfg)


@torch.no_grad()
def accuracy_sums(logits: torch.Tensor, targets: torch.Tensor,
                  chord_mask: torch.Tensor, melody_mask: torch.Tensor,
                  pad_id: int) -> Dict[str, torch.Tensor]:
    """Correct/total counts for total/chord/melody/others accuracy (the
    reference derives 'others' by subtracting chord and melody counts from
    the total)."""
    correct = (logits.argmax(-1) == targets).float()
    nonpad = (targets != pad_id).float()
    chord = (chord_mask == 1).float()
    melody = (melody_mask == 1).float()
    return {
        'total_correct': (correct * nonpad).sum(),
        'total_count': nonpad.sum(),
        'chord_correct': (correct * chord).sum(),
        'chord_count': chord.sum(),
        'melody_correct': (correct * melody).sum(),
        'melody_count': melody.sum(),
    }


def finalize_accuracy(sums: Dict[str, float]) -> Dict[str, float]:
    total = sums['total_correct'] / max(sums['total_count'], 1.0)
    chord = sums['chord_correct'] / max(sums['chord_count'], 1.0)
    melody = sums['melody_correct'] / max(sums['melody_count'], 1.0)
    other_count = sums['total_count'] - sums['chord_count'] - sums['melody_count']
    other_correct = (sums['total_correct'] - sums['chord_correct']
                     - sums['melody_correct'])
    others = other_correct / max(other_count, 1.0)
    return {'total': total, 'chord': chord, 'melody': melody, 'others': others}


class _MeshReduce:
    """The collectives of a step over a mesh (module docstring), on
    tensors on the model's device."""

    def __init__(self, mesh, optimizer: Optional[Optimizer] = None):
        self.group = data_group(mesh)
        if optimizer is not None and tp_size(mesh) > 1:
            optimizer.tp_group = tp_group(mesh)

    def share(self, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
        """This rank's share of the global non-PAD count (1 on a world of
        one): the local mean times it is the local sum over the global
        count."""
        n = aux['total_count'].detach()
        total = n.clone()
        dist.all_reduce(total, group=self.group)
        return n / total.clamp(min=1.0)

    def grads(self, params) -> None:
        """Sum the gradients over the data axes, one flat buffer a dtype."""
        by_dtype: Dict[torch.dtype, list] = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.group)
            o = 0
            for g in grads:
                g.copy_(flat[o:o + g.numel()].view_as(g))
                o += g.numel()

    def totals(self, loss_part: torch.Tensor, aux: Dict[str, torch.Tensor]):
        """(global loss, global aux) from this rank's loss share and sums."""
        keys = list(aux)
        vec = torch.stack([loss_part.detach().float()]
                          + [aux[k].float() for k in keys])
        dist.all_reduce(vec, group=self.group)
        return vec[0], dict(zip(keys, vec[1:].unbind()))


def make_train_step(loss_fn: Callable, model: nn.Module, optimizer: Optimizer,
                    mesh=None):
    """``step(batch, extras) -> (loss, aux)``: one micro-batch forward and
    backward in ``train()`` mode (dropout on), then ``optimizer.step()``.
    ``loss_fn(batch, extras) -> (loss, aux)``; ``batch`` is a dict of
    [B, ...] tensors on the model's device (this rank's rows over a
    ``mesh``), ``extras`` a dict of side inputs (the Performer's FAVOR+
    omegas).  Over a mesh the loss is the global masked mean and the
    gradients are summed over the data axes (module docstring)."""
    if mesh is None:
        def step(batch, extras):
            model.train()
            loss, aux = loss_fn(batch, extras)
            loss.backward()
            optimizer.step()
            return loss.detach(), aux
        return step
    red = _MeshReduce(mesh, optimizer)

    def mesh_step(batch, extras):
        model.train()
        loss, aux = loss_fn(batch, extras)
        share = red.share(aux)
        (loss * share).backward()
        if optimizer.updates_next:
            red.grads(optimizer.params)
        optimizer.step()
        return red.totals(loss * share, aux)
    return mesh_step


def make_eval_step(loss_fn: Callable, model: nn.Module, mesh=None):
    """``step(batch, extras) -> (loss, aux)`` in ``eval()`` mode, no grad;
    over a mesh the global masked mean and sums."""
    red = None if mesh is None else _MeshReduce(mesh)

    @torch.no_grad()
    def step(batch, extras):
        model.eval()
        loss, aux = loss_fn(batch, extras)
        if red is None:
            return loss, aux
        return red.totals(loss * red.share(aux), aux)
    return step


def stage1_loss_fn(model: nn.Module, pad_id: int):
    """The stage-1 loss (``trainer.py:164-174`` of the JAX package): masked
    cross-entropy and the accuracy sums on the chord and melody masks; no
    side inputs."""
    def loss_fn(batch, extras):
        del extras
        logits, _ = model(batch['dec_inp'])
        loss = masked_cross_entropy(logits, batch['dec_tgt'], pad_id)
        aux = accuracy_sums(logits, batch['dec_tgt'], batch['inp_chord'],
                            batch['inp_melody'], pad_id)
        return loss, aux
    return loss_fn


def make_segmented_train_step(model: nn.Module, pad_id: int,
                              optimizer: Optimizer, mesh=None):
    """Stage-1 multi-segment train step with XL memory recurrence
    (``trainer.py:177-214``; reference ``stage1_compose/train.py:27-74``):
    ``step(seg_batch, mems) -> (new_mems, loss, aux)`` runs one segment's
    forward over the carried memories and takes one optimizer step.
    ``seg_batch`` holds [B, L] tensors and ``seg_len`` [B]; ``mems`` is
    [n_layer + 1, B, mlen, D].  The new memories come from this forward's
    hidden states by the per-sample variable-length update, detached.  Over
    a ``mesh`` the memories of this rank's rows stay local, and the loss and
    gradients are reduced as :func:`make_train_step` reduces them."""
    red = None if mesh is None else _MeshReduce(mesh, optimizer)

    def step(seg_batch, mems):
        model.train()
        logits, _, hids = model(seg_batch['dec_inp'], list(mems),
                                return_hiddens=True)
        loss = masked_cross_entropy(logits, seg_batch['dec_tgt'], pad_id)
        aux = accuracy_sums(logits, seg_batch['dec_tgt'],
                            seg_batch['inp_chord'], seg_batch['inp_melody'],
                            pad_id)
        if red is None:
            loss.backward()
            optimizer.step()
            loss = loss.detach()
        else:
            share = red.share(aux)
            (loss * share).backward()
            if optimizer.updates_next:
                red.grads(optimizer.params)
            optimizer.step()
            loss, aux = red.totals(loss * share, aux)
        new_mems = torch.stack([
            update_mems_varlen(m, h.detach(), seg_batch['seg_len'])
            for m, h in zip(mems, hids)])
        return new_mems, loss, aux
    return step


def stage2_performer_loss_fn(model: nn.Module, pad_id: int):
    def loss_fn(batch, extras):
        logits = model(batch['dec_inp'], extras['omegas'], batch['track_mask'])
        loss = masked_cross_entropy(logits, batch['dec_tgt'], pad_id)
        aux = accuracy_sums(logits, batch['dec_tgt'], batch['chord_idx'],
                            batch['melody_idx'], pad_id)
        return loss, aux
    return loss_fn


def stage2_gpt2_loss_fn(model: nn.Module, pad_id: int):
    """The GPT-2 loss (``trainer.py:230-240`` of the JAX package): no side
    inputs, so ``extras`` is ignored."""
    def loss_fn(batch, extras):
        del extras
        logits = model(batch['dec_inp'], batch['track_mask'])
        loss = masked_cross_entropy(logits, batch['dec_tgt'], pad_id)
        aux = accuracy_sums(logits, batch['dec_tgt'], batch['chord_idx'],
                            batch['melody_idx'], pad_id)
        return loss, aux
    return loss_fn


def dropout_seed(seed: int, mesh=None) -> int:
    """The seed of a driver's dropout masks: ``seed + 1`` on one device,
    apart by data rank over a mesh (a tp group shares its masks, as its
    activations are replicated)."""
    return seed + 1 + 7919 * data_rank(mesh)


def neutralize_pad_rows(batch: dict, batch_size: int, pad_id: int) -> dict:
    """Pad a short batch to full size with rows whose targets are all PAD
    (zero loss/metric weight; ``train/train_stage1.py:37-53`` of the JAX
    package)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        n = v.shape[0]
        if n < batch_size:
            fill = np.repeat(v[-1:], batch_size - n, axis=0)
            if k in ('dec_tgt',):
                fill = np.full_like(fill, pad_id)
            if k in ('inp_chord', 'inp_melody', 'chord_idx', 'melody_idx'):
                fill = np.zeros_like(fill)
            v = np.concatenate([v, fill], axis=0)
        out[k] = v
    return out


def batch_to_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    """numpy batch -> int64 tensors on ``device`` (``length`` dropped)."""
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.long).to(device)
            for k, v in batch.items() if k != 'length'}
