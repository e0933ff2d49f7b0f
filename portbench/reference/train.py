"""The reference's training: the first updates of a training run, followed
step for step in float32 with TF32 off, and the numbers that compare the
program's run with them.

The optimizer is the published recipe: the global-norm clip at 0.5 of the
mean micro-batch gradient, then Adam (b1 0.9, b2 0.999, eps 1e-8, bias
corrected) at the warmup-then-cosine rate of the update's index (0 for the
first), one update every ``accum_steps`` micro-batches.  Dropout draws its
masks from torch's CUDA generator in the program's order of sites, so both
sides drop the same elements (see ``DropoutReplay``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from . import models


def learning_rate(opt: dict, update: int) -> float:
    if update < opt['warmup_steps']:
        return opt['lr'] * update / max(opt['warmup_steps'], 1)
    t = update - opt['warmup_steps']
    return opt['eta_min'] + (opt['lr'] - opt['eta_min']) * 0.5 * (
        1.0 + math.cos(math.pi * t / opt['T_max']))


class DropoutReplay:
    """The dropout masks of one micro-batch, drawn again: torch's fused
    dropout on CUDA takes its bits from the default generator by a Philox
    offset that each call advances by an amount fixed by the tensor's size,
    so drawing ``F.dropout`` over ones of the program's shapes and dtype,
    in the program's order, after the same ``manual_seed``, gives the
    program's masks.  ``apply(site, x, rows)`` drops the rows ``rows`` of
    site ``site``."""

    def __init__(self, shapes, p: float, dtype, device):
        self.p = p
        self.masks = [F.dropout(torch.ones(s, dtype=dtype, device=device),
                                p, True) != 0 for s in shapes]

    def apply(self, site: int, x: torch.Tensor, rows: slice) -> torch.Tensor:
        return x * self.masks[site][rows].to(x.dtype) / (1.0 - self.p)


def micro_batch_grads(P: Dict[str, torch.Tensor], cfg: dict, batch: dict,
                      omegas, replay: Optional[DropoutReplay], pad_id: int,
                      block_rows: int, quant: Callable = models._ident):
    """The masked-mean loss of one micro-batch and its gradient added into
    each ``P[name].grad``, computed ``block_rows`` rows at a time (the
    blocks' sums over the batch's whole count of non-PAD targets)."""
    tok, tgt, seg = batch['tokens'], batch['targets'], batch['seg']
    n = tok.shape[0]
    count = (tgt != pad_id).sum().clamp(min=1).double()
    total = 0.0
    for r0 in range(0, n, block_rows):
        rows = slice(r0, min(r0 + block_rows, n))
        drop = None if replay is None else (
            lambda site, x, rows=rows: replay.apply(site, x, rows))
        logits = models.forward(P, cfg, tok[rows], seg[rows], omegas, drop,
                                quant)
        s, _ = models.nll_sum(logits, tgt[rows], pad_id)
        (s / count.float()).backward()
        total += float(s.detach())
        del logits, s
    return total / float(count)


def follow(P0: Dict[str, torch.Tensor], cfg: dict, batches: List[dict],
           omegas_for: Callable, replay_for: Callable, pad_id: int,
           block_rows: int, quant: Callable = models._ident) -> dict:
    """Run the first ``len(batches) / accum_steps`` updates from the
    weights ``P0``.  ``omegas_for(i)`` gives micro-batch i's features (None
    for GPT-2), ``replay_for(i)`` its dropout masks.  Returns every
    micro-batch's loss, the first update's clipped gradient and each
    parameter's change over all the updates, by name."""
    opt = cfg['training']
    k = opt['accum_steps']
    P = {n: t.detach().clone().requires_grad_(True) for n, t in P0.items()}
    m = {n: torch.zeros_like(t) for n, t in P.items()}
    v = {n: torch.zeros_like(t) for n, t in P.items()}
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        losses.append(micro_batch_grads(P, cfg, batch, omegas_for(i),
                                        replay_for(i), pad_id, block_rows,
                                        quant))
        if (i + 1) % k:
            continue
        u = (i + 1) // k - 1
        with torch.no_grad():
            g = {n: (t.grad if t.grad is not None else torch.zeros_like(t)) / k
                 for n, t in P.items()}
            norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values()))
            scale = 1.0 if norm < opt['clip_norm'] else opt['clip_norm'] / float(norm)
            lr = learning_rate(opt, u)
            b1, b2, eps = 0.9, 0.999, 1e-8
            for n, t in P.items():
                gn = g[n] * scale
                m[n].mul_(b1).add_(gn, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(gn, gn, value=1 - b2)
                c1, c2 = 1 - b1 ** (u + 1), 1 - b2 ** (u + 1)
                denom = (v[n].sqrt() / math.sqrt(c2)).add_(eps)
                t.addcdiv_(m[n], denom, value=-lr / c1)
                t.grad = None
            if first_grad is None:
                first_grad = {n: g[n] * scale for n in P}
    change = {n: (P[n].detach() - P0[n]) for n in P}
    return {'losses': losses, 'first_grad': first_grad, 'change': change}


def leaf_gap(got: Dict[str, float], ref: Dict[str, float],
             names: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between two norms: |got - ref| over the larger
    of that leaf's reference norm and the median leaf's."""
    names = names if names is not None else list(ref)
    med = float(torch.tensor([ref[n] for n in ref]).median())
    return max(abs(got[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def compare(program: dict, ref: dict) -> Dict[str, float]:
    """The three numbers: the largest relative gap of a micro-batch's loss;
    the worst leaf's gap of the first update's gradient norm; the worst
    leaf's gap of the change's norm, over the leaves whose reference
    gradient is at least a thousandth of the median leaf's (a key bias
    under softmax has none, and Adam moves such a leaf by round-off)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(program['losses'],
                                                   ref['losses']))
    gnorm = lambda d: {n: float(t.double().norm()) for n, t in d.items()}
    g_ref = gnorm(ref['first_grad'])
    med = float(torch.tensor(list(g_ref.values())).median())
    moved = [n for n in g_ref if g_ref[n] >= 1e-3 * med]
    return {'loss': loss,
            'grad': leaf_gap(gnorm(program['first_grad']), g_ref),
            'change': leaf_gap(gnorm(program['change']), gnorm(ref['change']),
                               moved)}
