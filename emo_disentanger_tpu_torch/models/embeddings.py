"""Embedding and positional-encoding modules.

Port of ``emo_disentanger_tpu/models/embeddings.py``:

* ``TokenEmbedding`` scales by sqrt(d_proj); the optional bias-free ``proj``
  exists only when d_embed != d_proj.  Parameter names follow the reference
  checkpoint (``emb_lookup.weight``).
* ``LayerNorm`` is ``nn.LayerNorm`` with eps 1e-5, in the input's dtype.
* ``sinusoid_position_encoding`` interleaves sin (even features) and cos
  (odd features), the stage-2 convention; ``txl_positional_embedding``
  concatenates [sin | cos] halves, the Transformer-XL convention
  (``optimus_txl_decoder.py:8-24``).
* With ``pad_id`` the embedding of a PAD token is zero, as the stage-1
  model's is (the reference's ``padding_idx``).
"""

from __future__ import annotations

from typing import Optional

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
                 pad_id: Optional[int] = None, device=None):
        super().__init__()
        self.emb_lookup = nn.Embedding(n_token, d_embed, device=device)
        self.proj = (nn.Linear(d_embed, d_proj, bias=False, device=device)
                     if d_proj != d_embed else None)
        self.emb_scale = d_proj ** 0.5
        self.pad_id = pad_id

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.emb_lookup(tokens)
        if self.pad_id is not None:
            emb = torch.where((tokens == self.pad_id)[..., None], 0.0, emb)
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


def txl_positional_embedding(pos_seq: torch.Tensor, d_model: int) -> torch.Tensor:
    """[K] positions -> [K, d_model] float32 with [sin | cos] halves."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0.0, d_model, 2.0,
                                             device=pos_seq.device) / d_model))
    ang = pos_seq.float()[:, None] * inv_freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
