"""Single-device trainer for both stages (port of
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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable

import numpy as np
import torch
from torch import nn

from ..models.txl import masked_cross_entropy, update_mems_varlen
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

    def step(self) -> bool:
        """Count one micro-batch; on every ``accum_steps``-th, update the
        parameters and clear the gradients.  Returns whether it updated."""
        self.micro += 1
        k = self.cfg.accum_steps
        if self.micro < k:
            return False
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads])) / k
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


def make_train_step(loss_fn: Callable, model: nn.Module, optimizer: Optimizer):
    """``step(batch, extras) -> (loss, aux)``: one micro-batch forward and
    backward in ``train()`` mode (dropout on), then ``optimizer.step()``.
    ``loss_fn(batch, extras) -> (loss, aux)``; ``batch`` is a dict of
    [B, ...] tensors on the model's device, ``extras`` a dict of side inputs
    (the Performer's FAVOR+ omegas)."""
    def step(batch, extras):
        model.train()
        loss, aux = loss_fn(batch, extras)
        loss.backward()
        optimizer.step()
        return loss.detach(), aux
    return step


def make_eval_step(loss_fn: Callable, model: nn.Module):
    """``step(batch, extras) -> (loss, aux)`` in ``eval()`` mode, no grad."""
    @torch.no_grad()
    def step(batch, extras):
        model.eval()
        return loss_fn(batch, extras)
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
                              optimizer: Optimizer):
    """Stage-1 multi-segment train step with XL memory recurrence
    (``trainer.py:177-214``; reference ``stage1_compose/train.py:27-74``):
    ``step(seg_batch, mems) -> (new_mems, loss, aux)`` runs one segment's
    forward over the carried memories and takes one optimizer step.
    ``seg_batch`` holds [B, L] tensors and ``seg_len`` [B]; ``mems`` is
    [n_layer + 1, B, mlen, D].  The new memories come from this forward's
    hidden states by the per-sample variable-length update, detached."""
    def step(seg_batch, mems):
        model.train()
        logits, _, hids = model(seg_batch['dec_inp'], list(mems),
                                return_hiddens=True)
        loss = masked_cross_entropy(logits, seg_batch['dec_tgt'], pad_id)
        aux = accuracy_sums(logits, seg_batch['dec_tgt'],
                            seg_batch['inp_chord'], seg_batch['inp_melody'],
                            pad_id)
        loss.backward()
        optimizer.step()
        new_mems = torch.stack([
            update_mems_varlen(m, h.detach(), seg_batch['seg_len'])
            for m, h in zip(mems, hids)])
        return new_mems, loss.detach(), aux
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
