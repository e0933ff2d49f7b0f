"""Embedding and positional-encoding modules.

Port of ``emo_disentanger_tpu/models/embeddings.py``:

* ``TokenEmbedding`` scales by sqrt(d_proj); the optional bias-free ``proj``
  exists only when d_embed != d_proj.  Parameter names follow the reference
  checkpoint (``emb_lookup.weight``).
* ``LayerNorm`` is ``nn.LayerNorm`` with eps 1e-5, in the input's dtype.
* ``sinusoid_position_encoding`` interleaves sin (even features) and cos
  (odd features), the stage-2 convention.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.LayerNorm):
    """LayerNorm with eps 1e-5 (parameters ``weight``/``bias``), applied in
    the input's dtype (its parameters cast to it)."""

    def __init__(self, d: int, *, device=None, dtype=None):
        super().__init__(d, eps=1e-5, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class TokenEmbedding(nn.Module):
    def __init__(self, n_token: int, d_embed: int, d_proj: int, *,
                 device=None):
        super().__init__()
        self.emb_lookup = nn.Embedding(n_token, d_embed, device=device)
        self.proj = (nn.Linear(d_embed, d_proj, bias=False, device=device)
                     if d_proj != d_embed else None)
        self.emb_scale = d_proj ** 0.5

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.emb_lookup(tokens)
        if self.proj is not None:
            emb = self.proj(emb)
        return emb * self.emb_scale


def sinusoid_position_encoding(n_pos: int, d_model: int, offset: int = 0,
                               device=None) -> torch.Tensor:
    """[n_pos, d_model] float32 interleaved sin/cos absolute encoding."""
    position = torch.arange(offset, offset + n_pos, dtype=torch.float32,
                            device=device)[:, None]
    # the frequency step in float32, as the reference computes it
    step = -torch.log(torch.tensor(10000.0, device=device)) / d_model
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device) * step)
    pe = torch.zeros(n_pos, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe
