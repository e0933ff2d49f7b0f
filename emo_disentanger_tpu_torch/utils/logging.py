"""Training log files in the reference's formats (port of
``emo_disentanger_tpu/utils/logging.py``).

``log.txt``: fixed-width ep/steps/loss/time lines (reference ``log_epoch``,
``stage1_compose/train.py:160-176``).  ``valloss.txt``: one line per
validation pass with loss mean/std and the four accuracies
(``stage1_compose/train.py:328-344``).
"""

from __future__ import annotations

import os
import time
from typing import Dict


class EpochLogger:
    def __init__(self, log_path: str):
        self.log_path = log_path
        self.init_time = time.time()

    def log(self, ep: int, steps: int, ce_loss: float, ep_time: float) -> None:
        is_init = not os.path.exists(self.log_path)
        os.makedirs(os.path.dirname(self.log_path) or '.', exist_ok=True)
        with open(self.log_path, 'a') as f:
            if is_init:
                f.write('{:4} {:8} {:12} {:12} {:12}\n'.format(
                    'ep', 'steps', 'ce_loss', 'ep_time', 'total_time'))
            f.write('{:<4} {:<8} {:<12} {:<12} {:<12}\n'.format(
                ep, steps, round(ce_loss, 5), round(ep_time, 2),
                round(time.time() - self.init_time, 2)))


def write_valloss_line(path: str, ep: int, loss: float, val_mean: float,
                       val_std: float, acc: Dict[str, float]) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'a') as f:
        f.write('ep{:03d} | loss: {:.3f} | valloss: {:.3f} (±{:.3f}) | '
                'total_acc: {:.3f} | chord_acc: {:.3f} | melody_acc: {:.3f} | '
                'others_acc: {:.3f}\n'.format(
                    ep, loss, val_mean, val_std,
                    acc['total'], acc['chord'], acc['melody'], acc['others']))
