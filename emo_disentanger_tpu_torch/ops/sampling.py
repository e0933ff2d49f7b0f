"""Temperature + nucleus (top-p) sampling.

Port of ``emo_disentanger_tpu/ops/sampling.py``, batched over rows.  It
keeps the reference sampler's two quirks (``inference_utils.py:14-41``):

* the nucleus keeps the sorted tokens strictly before the SECOND index whose
  cumulative probability exceeds p;
* when no index exceeds p (only possible for p >= 1) the top 3 are kept;

and, like the JAX sampler, keeps everything but the last token when exactly
one index exceeds p, and at least one token always.  ``top_p=0`` keeps only
the most probable token, so the draw is the argmax whatever the generator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


NEG_INF = -1e30


def nucleus_sample(logits: torch.Tensor, temperature: float, top_p: float,
                   generator: torch.Generator,
                   forbid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample one token id per row of ``logits`` [B, V] -> [B] int64.
    ``generator`` must live on the logits' device.  ``forbid``: optional
    bool mask [V] on that device; its True entries get ``NEG_INF`` before
    the softmax, as the JAX sampler does (the reference subtracts inf from
    inadmissible tempo logits, ``stage2_accompaniment/inference.py:71-73``)."""
    logits = logits.float()
    if forbid is not None:
        logits = torch.where(forbid, NEG_INF, logits)
    probs = torch.softmax(logits / temperature, dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    after = sorted_probs.cumsum(-1) > top_p
    n_after = after.sum(-1)
    # index of the second True (the reference's np.where(after)[0][1])
    second_true = (after.cumsum(-1) >= 2).int().argmax(-1)
    V = logits.shape[-1]
    keep_n = torch.where(n_after >= 2, second_true,
                         torch.where(n_after == 1, V - 1, 3)).clamp(min=1)
    idx = torch.arange(V, device=logits.device)
    candi = torch.where(idx[None, :] < keep_n[:, None], sorted_probs, 0.0)
    candi = candi / candi.sum(-1, keepdim=True)
    choice = torch.multinomial(candi, 1, generator=generator)
    return order.gather(-1, choice)[:, 0]


def nucleus_sample_numpy(rng: np.random.RandomState, logits: np.ndarray,
                         temperature: float, top_p: float,
                         forbid: Optional[np.ndarray] = None) -> int:
    """Host-side sampler with semantics identical to the reference
    (``inference_utils.py:14-41``), for parity tests and debugging."""
    logits = np.asarray(logits, dtype=np.float64)
    if forbid is not None:
        logits = np.where(forbid, -np.inf, logits)
    x = logits / temperature
    x = x - np.max(x)                                  # stable softmax
    probs = np.exp(x) / np.sum(np.exp(x))

    probs = probs / probs.sum()
    sorted_index = np.argsort(probs)[::-1]
    sorted_probs = probs[sorted_index]
    cusum = np.cumsum(sorted_probs)
    after = cusum > top_p
    if after.sum() >= 2:
        last_index = np.where(after)[0][1]
        candi_index = sorted_index[:last_index]
    elif after.sum() == 1:
        candi_index = sorted_index[:np.where(after)[0][0]]
        if len(candi_index) == 0:
            candi_index = sorted_index[:1]
    else:
        candi_index = sorted_index[:3]
    candi_probs = np.array([probs[i] for i in candi_index], dtype=np.float64)
    candi_probs /= candi_probs.sum()
    return int(rng.choice(candi_index, size=1, p=candi_probs)[0])
