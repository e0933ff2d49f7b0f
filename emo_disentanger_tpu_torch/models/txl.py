"""Stage-1 Transformer-XL (port of ``emo_disentanger_tpu/models/txl.py``).

So far only the loss shared with stage 2 is ported; the TXL model comes
with stage 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         pad_id: int) -> torch.Tensor:
    """Mean negative log-likelihood over the non-PAD targets, in float32
    (``models/txl.py:496-502``); 0 when every target is PAD."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    mask = (targets != pad_id).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
