"""Temperature + nucleus (top-p) sampling.

Port of ``emo_disentanger_tpu/ops/sampling.py``, batched over rows.  It
keeps the reference sampler's two quirks (``inference_utils.py:14-41``):

* the nucleus keeps the sorted tokens strictly before the SECOND index whose
  cumulative probability exceeds p;
* when no index exceeds p (only possible for p >= 1) the top 3 are kept;

and, like the JAX sampler, keeps everything but the last token when exactly
one index exceeds p, and at least one token always.  ``top_p=0`` keeps only
the most probable token, so the draw is the argmax whatever the generator.

The draw is the inverse CDF over the kept nucleus at a uniform ``u`` per
row: the first kept token whose cumulative probability exceeds ``u``.  A
row's draw depends on its own logits and its own ``u`` only, never on the
batch's shape, so a rank that samples its rows of a batch draws what one
device sampling the whole batch draws for them, given the same uniforms
(the batched generators draw ``torch.rand(B_global)`` each step on every
rank and keep their rows).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


NEG_INF = -1e30


def nucleus_sample(logits: torch.Tensor,
                   temperature: Union[float, torch.Tensor],
                   top_p: Union[float, torch.Tensor],
                   draw: Union[torch.Generator, torch.Tensor],
                   forbid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample one token id per row of ``logits`` [B, V] -> [B] int64.
    ``temperature`` and ``top_p`` are floats, or tensors [B] of per-row
    values on the logits' device (stage 1's key step samples some rows at
    its own settings, all rows from one sort).  ``draw`` is the uniforms
    ``u`` [B] in [0, 1) on the logits' device, or a generator there from
    which they are drawn (``torch.rand(B)``).  ``forbid``: optional bool mask [V] on that device;
    its True entries get ``NEG_INF`` before the softmax, as the JAX sampler
    does (the reference subtracts inf from inadmissible tempo logits,
    ``stage2_accompaniment/inference.py:71-73``)."""
    logits = logits.float()
    if forbid is not None:
        logits = torch.where(forbid, NEG_INF, logits)
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.float()[:, None]
    if isinstance(top_p, torch.Tensor):
        top_p = top_p.float()[:, None]
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
    cdf = (candi / candi.sum(-1, keepdim=True)).cumsum(-1)
    u = draw if isinstance(draw, torch.Tensor) else torch.rand(
        logits.shape[0], generator=draw, device=logits.device)
    choice = torch.searchsorted(cdf, u.float()[:, None], right=True)
    # rounding can leave the last kept cumulative sum below u
    choice = torch.minimum(choice, (keep_n - 1)[:, None])
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
