"""Stage-2 model, option 1: Performer (FAVOR+ causal linear attention).

Port of ``emo_disentanger_tpu/models/performer.py``: the training forward
(dropout at the JAX sites), the loss, and the O(1)-per-token decode.  Token
embedding scaled by sqrt(d), additive segment embedding, interleaved
sinusoidal positions, post-norm layers of
attn -> add -> norm1 -> FF -> add -> norm2 with biased projections.

Parameter names follow the reference checkpoint (``token_emb.emb_lookup``,
``transformer_decoder.decoder_layers.{i}.attention.query_projection``, ...,
``dec_out_proj``), so a released state dict loads by name; the FAVOR+
feature matrices ``omegas`` [n_layer, d_head, M] are explicit float32
inputs, never parameters.

Precision.  The forward computes in ``compute_dtype`` when it is given and
in the parameters' dtype otherwise: the embedding sum is cast to it once,
and every projection and LayerNorm casts its weights to the activations'
dtype.  So bf16 training keeps float32 master weights (and float32 Adam
state), computes in bf16 and gets float32 gradients through the casts, as
the JAX modules with ``dtype=bfloat16`` do; serving casts the parameters
themselves (``utils.precision.cast_params``).  The FAVOR+ kernels get bf16
q/k/v under bf16 compute, so their bf16 path is the one that trains.  The
vocabulary head runs in float32.  An explicit dtype was chosen over
``torch.autocast`` because autocast would keep LayerNorm outputs and the
residual stream in float32 and would also cast the float32 vocabulary head
and the plain FAVOR+ scans to bf16.  The decode follows the parameters'
dtype only.

Dropout (rate ``dropout``, 0.1 by default) sits where the JAX model has it:
on the embedding sum and, in each layer, on ``out_proj(attn)`` before the
residual, on ``relu(linear1)`` and on ``linear2`` -- 1 + 3 * n_layer sites.
It is active in ``train()`` mode only, so serving calls ``eval()`` first.
It is ``nn.Dropout`` with the reference PyTorch model's semantics
(``stage2_accompaniment/model/fast_transformer_decoder.py``): each element
is zeroed with probability ``dropout`` exactly and the survivors scaled by
1 / (1 - dropout), drawn by torch's own generator (Philox on CUDA).  The
JAX package defaults to another draw (``models/dropout.py:11-21,53-58``): a
uint8 mask compared against round(rate * 256), which quantizes rate 0.1 to
26/256 = 0.1016.  That is a TPU economy of random bits, not a property of
the model; ``EMODIS_DROPOUT_BITECON=0`` gives the JAX package the semantics
kept here.  Neither framework reproduces the other's random stream, so the
two are compared by distribution only.

Attention layout.  By default a layer splits q, k and v into heads
([B, H, L, Dh]) around ``favor_causal_attention``, as the JAX layer does.
With ``heads_last=True``, or ``EMODIS_HL_ATTN`` set to anything but ``0``
when ``heads_last`` is None (read at construction; the JAX layer reads it
while it traces), the layer hands the [B, L, D] projections to
``favor_causal_attention_heads_last`` and its [B, L, D] result straight to
the output projection (``models/performer.py:83-88`` there): the same
function, without the head-split copies.  Parameter names are the same in
both layouts, and the decode is the same.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.linear_attention import (
    draw_orthogonal_features, favor_causal_attention,
    favor_causal_attention_heads_last)
from ..ops.performer_decode import fused_decode_layer
from ..utils.device import resolve_device
from .embeddings import LayerNorm, TokenEmbedding, sinusoid_position_encoding
from .txl import masked_cross_entropy


def _heads_last_from_env() -> bool:
    """The JAX layer's switch: ``EMODIS_HL_ATTN`` unset or ``'0'`` means
    head-major."""
    return os.environ.get('EMODIS_HL_ATTN', '0') != '0'


def _linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``mod`` applied in ``x``'s dtype (its weights cast to it)."""
    return F.linear(x, mod.weight.to(x.dtype), mod.bias.to(x.dtype))


class AttentionLayer(nn.Module):
    """The four biased projections around the attention core."""

    def __init__(self, d_model: int, *, device=None):
        super().__init__()
        lin = lambda: nn.Linear(d_model, d_model, device=device)
        self.query_projection = lin()
        self.key_projection = lin()
        self.value_projection = lin()
        self.out_projection = lin()


class PerformerLayer(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_ff: int, *,
                 dropout: float = 0.1, heads_last: Optional[bool] = None,
                 device=None):
        super().__init__()
        self.n_head = n_head
        self.heads_last = (_heads_last_from_env() if heads_last is None
                           else heads_last)
        self.attention = AttentionLayer(d_model, device=device)
        self.linear1 = nn.Linear(d_model, d_ff, device=device)
        self.linear2 = nn.Linear(d_ff, d_model, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
        """x [B, L, D]; omega [d_head, M]."""
        B, L, D = x.shape
        a = self.attention
        q, k, v = (_linear(p, x) for p in (a.query_projection, a.key_projection,
                                           a.value_projection))
        if self.heads_last:
            attn = favor_causal_attention_heads_last(q, k, v, omega, self.n_head)
        else:
            heads = lambda t: t.reshape(B, L, self.n_head, -1).transpose(1, 2)
            attn = favor_causal_attention(heads(q), heads(k), heads(v), omega)
            attn = attn.transpose(1, 2).reshape(B, L, D)
        x = x + self.drop(_linear(a.out_projection, attn.to(x.dtype)))
        y = x = self.norm1(x)
        y = self.drop(F.relu(_linear(self.linear1, y)))
        y = self.drop(_linear(self.linear2, y))
        return self.norm2(x + y)

    def decode_params(self) -> Dict[str, torch.Tensor]:
        """This layer's parameters under ``ops.performer_decode.PARAM_KEYS``."""
        a = self.attention
        return {
            'wq': a.query_projection.weight, 'bq': a.query_projection.bias,
            'wk': a.key_projection.weight, 'bk': a.key_projection.bias,
            'wv': a.value_projection.weight, 'bv': a.value_projection.bias,
            'wo': a.out_projection.weight, 'bo': a.out_projection.bias,
            'w1': self.linear1.weight, 'b1': self.linear1.bias,
            'w2': self.linear2.weight, 'b2': self.linear2.bias,
            'g1': self.norm1.weight, 'be1': self.norm1.bias,
            'g2': self.norm2.weight, 'be2': self.norm2.bias,
        }

    def decode_step(self, x: torch.Tensor, omega: torch.Tensor,
                    S: torch.Tensor, z: torch.Tensor,
                    update_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, D] -> [B, D]; S [B, H, Dh, M] / z [B, H, M] are updated in
        place; ``update_mask`` [B] freezes masked elements' state."""
        return fused_decode_layer(x, S, z, self.decode_params(), omega,
                                  update_mask, n_head=self.n_head)


class TransformerDecoder(nn.Module):
    def __init__(self, n_layer: int, n_head: int, d_model: int, d_ff: int, *,
                 dropout: float = 0.1, heads_last: Optional[bool] = None,
                 device=None):
        super().__init__()
        self.decoder_layers = nn.ModuleList(
            PerformerLayer(n_head, d_model, d_ff, dropout=dropout,
                           heads_last=heads_last, device=device)
            for _ in range(n_layer))


class MusicPerformer(nn.Module):
    """Stage-2 Performer LM.  ``heads_last`` selects the attention layout
    (module docstring); None reads ``EMODIS_HL_ATTN`` once, here."""

    def __init__(self, n_token: int, n_layer: int = 12, n_head: int = 8,
                 d_model: int = 512, d_ff: int = 2048, d_embed: int = 512,
                 favor_dims: int = 128, use_segment_emb: bool = True,
                 n_segment_types: int = 2, use_pe: bool = True,
                 max_len: int = 12000, *, dropout: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None,
                 heads_last: Optional[bool] = None,
                 device: Union[str, torch.device] = 'cuda',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.heads_last = (_heads_last_from_env() if heads_last is None
                           else heads_last)
        self.n_token = n_token
        self.n_layer = n_layer
        self.n_head = n_head
        self.d_model = d_model
        self.d_head = d_model // n_head
        self.favor_dims = favor_dims
        self.use_pe = use_pe
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.token_emb = TokenEmbedding(n_token, d_embed, d_model, device=dev)
        self.segemb = (TokenEmbedding(n_segment_types, d_embed, d_model,
                                      device=dev) if use_segment_emb else None)
        self.emb_dropout = nn.Dropout(dropout)
        self.transformer_decoder = TransformerDecoder(
            n_layer, n_head, d_model, d_ff, dropout=dropout,
            heads_last=self.heads_last, device=dev)
        self.dec_out_proj = nn.Linear(d_model, n_token, device=dev)
        self.register_buffer('pe', sinusoid_position_encoding(
            max_len, d_embed, device=dev), persistent=False)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.dec_out_proj.weight.device

    @property
    def layers(self):
        return self.transformer_decoder.decoder_layers

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The reference initialization: N(0, 0.01) weights and embeddings,
        zero biases, N(1, 0.01) LayerNorm scales.  Draws on the CPU from
        ``generator`` (seed 0 when None), so weights do not depend on the
        device."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        randn = lambda p: torch.randn(p.shape, generator=g).to(p)
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.copy_(1.0 + 0.01 * randn(mod.weight))
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.copy_(0.01 * randn(mod.weight))
                if getattr(mod, 'bias', None) is not None:
                    mod.bias.zero_()

    def draw_omegas(self, generator: torch.Generator) -> torch.Tensor:
        """Per-layer FAVOR+ feature matrices [n_layer, d_head, M] float32 on
        the model's device."""
        return torch.stack([
            draw_orthogonal_features(self.d_head, self.favor_dims, generator)
            for _ in range(self.n_layer)]).to(self.device)

    def _embed(self, tokens, seg, pe_rows):
        emb = self.token_emb(tokens)
        if seg is not None and self.segemb is not None:
            emb = emb + self.segemb(seg)
        if self.use_pe:
            emb = emb + pe_rows.to(emb.dtype)
        return emb

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        w = self.dec_out_proj
        return torch.matmul(h.float(), w.weight.float().t()) + w.bias.float()

    def forward(self, tokens: torch.Tensor, omegas: torch.Tensor,
                seg: Optional[torch.Tensor] = None, *,
                keep_last_only: bool = False) -> torch.Tensor:
        """tokens [B, L], omegas [n_layer, d_head, M] -> logits [B, L, V]
        float32 ([B, V] with ``keep_last_only``).  Dropout is active in
        ``train()`` mode, which a new model is in: serving and evaluation
        call ``eval()`` first."""
        h = self._embed(tokens, seg, self.pe[:tokens.shape[1]])
        if self.compute_dtype is not None:
            h = h.to(self.compute_dtype)
        h = self.emb_dropout(h)
        for i, layer in enumerate(self.layers):
            h = layer(h, omegas[i])
        if keep_last_only:
            h = h[:, -1]
        return self._logits(h)

    # ------------------------------------------------------------ decode
    def init_decode_state(self, batch: int, state_layout: str = 'dm'
                          ) -> Dict[str, torch.Tensor]:
        """Zero FAVOR+ state in the 'dm' layout: S [n_layer, B, H, Dh, M]
        and z [n_layer, B, H, M], float32.  The port carries 'dm' only;
        ``state_layout`` exists so that callers of the JAX signature
        fail loudly on 'md'."""
        if state_layout != 'dm':
            raise ValueError(f"the port carries the 'dm' state layout only "
                             f"(got {state_layout!r})")
        kw = dict(dtype=torch.float32, device=self.device)
        return {
            'S': torch.zeros(self.n_layer, batch, self.n_head, self.d_head,
                             self.favor_dims, **kw),
            'z': torch.zeros(self.n_layer, batch, self.n_head,
                             self.favor_dims, **kw),
        }

    def decode_step(self, token: torch.Tensor, seg: torch.Tensor, t: int,
                    omegas: torch.Tensor, state: Dict[str, torch.Tensor],
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """token/seg [B], one position ``t`` for all -> (logits [B, V],
        state); the state is updated in place."""
        tv = torch.full(token.shape, t, dtype=torch.long, device=token.device)
        return self.decode_step_batchpos(token, seg, tv, omegas, state)

    def decode_step_batchpos(self, token: torch.Tensor, seg: torch.Tensor,
                             t: torch.Tensor, omegas: torch.Tensor,
                             state: Dict[str, torch.Tensor],
                             update_mask: Optional[torch.Tensor] = None,
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Like :meth:`decode_step` with a per-element position ``t`` [B]
        (each song advances its own clock; only the positional lookup
        depends on it).  ``update_mask`` [B] freezes masked elements' state.
        The state is updated in place and returned."""
        h = self._embed(token, seg, self.pe[t.clamp(0, self.max_len - 1)])
        mask = None if update_mask is None else update_mask.to(torch.float32)
        for i, layer in enumerate(self.layers):
            h = layer.decode_step(h, omegas[i], state['S'][i], state['z'][i],
                                  mask)
        return self._logits(h), state

    def compute_loss(self, logits: torch.Tensor, targets: torch.Tensor
                     ) -> torch.Tensor:
        """Cross-entropy ignoring PAD (= n_token - 1), reference
        ``music_performer.py:72-81``."""
        return masked_cross_entropy(logits, targets, self.n_token - 1)
