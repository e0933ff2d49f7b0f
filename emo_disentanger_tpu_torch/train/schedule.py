"""Learning-rate schedule: linear warmup -> cosine annealing.

Port of ``emo_disentanger_tpu/train/schedule.py`` (reference
``stage1_compose/train.py:70-74``): for ``step < warmup_steps`` the LR ramps
linearly as ``max_lr * step / warmup``; afterwards it follows torch's
``CosineAnnealingLR`` evaluated at ``step - warmup``:
eta_min + (max_lr - eta_min) * (1 + cos(pi t / T_max)) / 2.
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cosine(max_lr: float, min_lr: float, warmup_steps: int,
                  decay_steps: int) -> Callable[[int], float]:
    """The schedule as a function of the optimizer step (0 for the first)."""
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return max_lr * step / max(warmup_steps, 1)
        t = step - warmup_steps
        return min_lr + (max_lr - min_lr) * 0.5 * (1.0 + math.cos(
            math.pi * t / decay_steps))
    return schedule
