"""Stage-2 model, option 2: GPT-2 dense-attention decoder.

Port of ``emo_disentanger_tpu/models/gpt2.py``: the embedding of the
Performer (token embedding scaled by sqrt(d), segment embedding, interleaved
sinusoidal positions), pre-LN GPT-2 blocks (ln_1 -> causal attention with a
biased fused QKV projection and 1/sqrt(d_head) scaling -> residual; ln_2 ->
MLP with tanh-approximated GELU -> residual), no final LayerNorm, and the
vocabulary head in float32.  The decode carries a KV cache in JAX's 'khd'
layout [n_layer, B, Kmax, H, Dh] or its 'dk' layout [n_layer, B, H, Dh,
Kmax] (``ops.attention``; 'hkd' is refused, as JAX refuses it) and writes
each element's row at its own clock (``decode_step_batchpos``).

Parameter names follow the reference checkpoint (``token_emb.emb_lookup``,
``segemb.emb_lookup``, ``transformer_decoder.{i}.ln_1`` / ``.attn.c_attn`` /
``.attn.c_proj`` / ``.ln_2`` / ``.mlp.c_fc`` / ``.mlp.c_proj``,
``dec_out_proj``), and the block weights keep HF ``Conv1D``'s [in, out]
layout, so a reference state dict loads as it is.

Attention dispatch, as ``gpt2.py:68`` with the device in place of the
backend: in ``eval()`` mode, on CUDA tensors, with L >= 512 and
L % 128 == 0, a forward runs ``ops.flash_attention`` (the hand-written
kernel) on float32 q, k, v and casts the result back; every other case,
the CPU and ``train()`` mode (attention dropout) included, takes the
einsum path.  The decode attends over the whole cache with einsums in the
cache's dtype and a float32 softmax, as the JAX decode does.

Precision is the Performer's (``models/performer.py``): the forward computes
in ``compute_dtype`` when given, else in the parameters' dtype; the decode
and its cache follow the parameters' dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (
    NEG_INF, cache_positions, layout_equations, write_row_pe)
from ..ops.flash_attention import flash_attention
from ..parallel.sharding_rules import parallel_linear
from ..utils.device import resolve_device
from .embeddings import (
    LayerNorm, TokenEmbedding, head_f32, sinusoid_position_encoding)
from .txl import masked_cross_entropy


def _flash_applies(training: bool, q: torch.Tensor) -> bool:
    """``gpt2.py:68``'s condition for the flash-attention kernel, with the
    device in place of the backend; q [B, L, H, Dh]."""
    L = q.shape[1]
    return not training and q.is_cuda and L >= 512 and L % 128 == 0


def _check_layout(layout: str) -> None:
    if layout not in ('khd', 'dk'):
        raise ValueError(f"MusicGPT2 decode supports 'khd' and 'dk', got "
                         f'{layout!r}')


class Conv1D(nn.Module):
    """HF ``Conv1D``: ``x @ weight + bias`` with ``weight`` [in, out],
    applied in ``x``'s dtype."""

    def __init__(self, n_in: int, n_out: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return parallel_linear(self, x, _apply_conv1d)


def _apply_conv1d(x, weight, bias):
    return F.linear(x, weight.to(x.dtype).t(),
                    None if bias is None else bias.to(x.dtype))


class GPT2Attention(nn.Module):
    def __init__(self, d_model: int, *, device=None):
        super().__init__()
        self.c_attn = Conv1D(d_model, 3 * d_model, device=device)
        self.c_proj = Conv1D(d_model, d_model, device=device)

    def _load_from_state_dict(self, state_dict, prefix, *args):
        # checkpoints of older HF versions store the causal-mask constants
        # 'bias' and 'masked_bias' as buffers; they are not weights
        for name in ('bias', 'masked_bias'):
            state_dict.pop(prefix + name, None)
        super()._load_from_state_dict(state_dict, prefix, *args)


class GPT2MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device=None):
        super().__init__()
        self.c_fc = Conv1D(d_model, d_ff, device=device)
        self.c_proj = Conv1D(d_ff, d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate='tanh'))


class GPT2Block(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_ff: int, *,
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.n_head = n_head
        self.d_head = d_model // n_head
        self.ln_1 = LayerNorm(d_model, device=device)
        self.attn = GPT2Attention(d_model, device=device)
        self.ln_2 = LayerNorm(d_model, device=device)
        self.mlp = GPT2MLP(d_model, d_ff, device=device)
        self.attn_drop = nn.Dropout(dropout)
        self.resid_drop = nn.Dropout(dropout)
        self.mlp_drop = nn.Dropout(dropout)

    def _attention(self, q, k, v):
        """q, k, v [B, L, H, Dh] -> [B, L, H * Dh] causal attention."""
        B, L = q.shape[:2]
        scale = 1.0 / (self.d_head ** 0.5)
        if _flash_applies(self.training, q):
            heads = lambda t: t.transpose(1, 2).float().contiguous()
            attn = flash_attention(heads(q), heads(k), heads(v), causal=True,
                                   sm_scale=scale)
            return attn.transpose(1, 2).to(q.dtype).reshape(B, L, -1)
        scores = torch.einsum('bihd,bjhd->bhij', q, k) * scale
        mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores.float(), -1).to(scores.dtype)
        probs = self.attn_drop(probs)
        return torch.einsum('bhij,bjhd->bihd', probs, v).reshape(B, L, -1)

    def forward(self, x: torch.Tensor, return_kv: bool = False):
        """x [B, L, D] -> [B, L, D] (and k, v [B, L, H, Dh] with
        ``return_kv``).  Under tensor parallelism ``c_attn`` yields this
        rank's n_head / tp heads of each of q, k and v."""
        B, L, D = x.shape
        heads = lambda t: t.reshape(B, L, -1, self.d_head)
        qkv = self.attn.c_attn(self.ln_1(x))
        q, k, v = (heads(t) for t in qkv.split(qkv.shape[-1] // 3, -1))
        x = x + self.resid_drop(self.attn.c_proj(self._attention(q, k, v)))
        out = x + self.mlp_drop(self.mlp(self.ln_2(x)))
        return (out, k, v) if return_kv else out


class MusicGPT2(nn.Module):
    """Stage-2 GPT-2 LM."""

    def __init__(self, n_token: int, n_layer: int = 12, n_head: int = 8,
                 d_model: int = 512, d_ff: int = 2048, d_embed: int = 512,
                 use_segment_emb: bool = True, n_segment_types: int = 2,
                 use_pe: bool = True, max_len: int = 4096, *,
                 dropout: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = 'cuda',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.n_token = n_token
        self.n_layer = n_layer
        self.n_head = n_head
        self.d_model = d_model
        self.d_head = d_model // n_head
        self.use_pe = use_pe
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.token_emb = TokenEmbedding(n_token, d_embed, d_model, device=dev)
        self.segemb = (TokenEmbedding(n_segment_types, d_embed, d_model,
                                      device=dev) if use_segment_emb else None)
        self.emb_dropout = nn.Dropout(dropout)
        self.transformer_decoder = nn.ModuleList(
            GPT2Block(n_head, d_model, d_ff, dropout=dropout, device=dev)
            for _ in range(n_layer))
        self.dec_out_proj = nn.Linear(d_model, n_token, device=dev)
        self.register_buffer('pe', sinusoid_position_encoding(
            max_len, d_embed, device=dev), persistent=False)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.dec_out_proj.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX initialization: N(0, 0.01) weights and embeddings, zero
        biases, N(1, 0.01) LayerNorm scales, drawn on the CPU from
        ``generator`` (seed 0 when None)."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        randn = lambda p: torch.randn(p.shape, generator=g).to(p)
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.copy_(1.0 + 0.01 * randn(mod.weight))
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Embedding, Conv1D)):
                mod.weight.copy_(0.01 * randn(mod.weight))
                if getattr(mod, 'bias', None) is not None:
                    mod.bias.zero_()

    def _embed(self, tokens, seg, pe_rows):
        emb = self.token_emb(tokens)
        if seg is not None and self.segemb is not None:
            emb = emb + self.segemb(seg)
        if self.use_pe:
            emb = emb + pe_rows.to(emb.dtype)
        return emb

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return parallel_linear(self.dec_out_proj, h, head_f32)

    def forward(self, tokens: torch.Tensor, seg: Optional[torch.Tensor] = None,
                *, keep_last_only: bool = False, return_kv: bool = False):
        """tokens [B, L] -> logits [B, L, V] float32 ([B, V] with
        ``keep_last_only``); with ``return_kv`` also the per-layer k and v
        [n_layer, B, L, H, Dh] that (re)build a decode cache.  Dropout is
        active in ``train()`` mode; serving calls ``eval()`` first."""
        h = self._embed(tokens, seg, self.pe[:tokens.shape[1]])
        if self.compute_dtype is not None:
            h = h.to(self.compute_dtype)
        h = self.emb_dropout(h)
        ks, vs = [], []
        for block in self.transformer_decoder:
            if return_kv:
                h, k, v = block(h, return_kv=True)
                ks.append(k)
                vs.append(v)
            else:
                h = block(h)
        logits = self._logits(h[:, -1] if keep_last_only else h)
        if return_kv:
            return logits, torch.stack(ks), torch.stack(vs)
        return logits

    # ------------------------------------------------------------ decode
    @property
    def decode_dtype(self) -> torch.dtype:
        return self.transformer_decoder[0].attn.c_attn.weight.dtype

    def init_decode_cache(self, batch: int, max_klen: int, layout: str = 'khd'
                          ) -> Dict[str, torch.Tensor]:
        """Zero k and v caches in the decode dtype: 'khd' [n_layer, B,
        Kmax, H, Dh] or 'dk' [n_layer, B, H, Dh, Kmax] (``gpt2.py:219-231``).
        Pass the same ``layout`` to the decode steps."""
        _check_layout(layout)
        if getattr(self, 'tp_size', 1) > 1:
            raise NotImplementedError('a tensor-parallel model does not '
                                      'decode; serving shards the batch')
        H, Dh = self.n_head, self.d_head
        shape = (max_klen, H, Dh) if layout == 'khd' else (H, Dh, max_klen)
        k = torch.zeros((self.n_layer, batch) + shape, dtype=self.decode_dtype,
                        device=self.device)
        return {'k': k, 'v': torch.zeros_like(k)}

    def decode_step(self, token: torch.Tensor, seg: torch.Tensor, t: int,
                    cache: Dict[str, torch.Tensor], layout: str = 'khd',
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """token/seg [B], one position ``t`` for all -> (logits [B, V],
        cache); the cache is written in place."""
        tv = torch.full(token.shape, t, dtype=torch.long, device=token.device)
        return self.decode_step_batchpos(token, seg, tv, cache, layout)

    def decode_step_batchpos(self, token: torch.Tensor, seg: torch.Tensor,
                             t: torch.Tensor, cache: Dict[str, torch.Tensor],
                             layout: str = 'khd',
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Like :meth:`decode_step` with a per-element position ``t`` [B]:
        each element writes its cache row at its own clock (clamped to the
        cache, as JAX clamps) and attends over positions <= t.  Positional
        rows are clipped at ``max_len - 1``.  The cache (in ``layout``) is
        written in place and returned."""
        _check_layout(layout)
        eq_s, eq_v = layout_equations(layout)
        B = token.shape[0]
        h = self._embed(token, seg, self.pe[t.clamp(0, self.max_len - 1)])
        h = h.to(self.decode_dtype)
        k_all, v_all = cache['k'], cache['v']
        K = cache_positions(k_all[0], layout)
        masked = torch.arange(K, device=t.device)[None] > t[:, None]
        scale = 1.0 / (self.d_head ** 0.5)
        for i, block in enumerate(self.transformer_decoder):
            qkv = block.attn.c_attn(block.ln_1(h))
            q, k, v = (x.reshape(B, self.n_head, self.d_head)
                       for x in qkv.split(self.d_model, -1))
            k_layer = write_row_pe(k_all[i], k, t, layout)
            v_layer = write_row_pe(v_all[i], v, t, layout)
            scores = torch.einsum(eq_s, q, k_layer) * scale
            scores = torch.where(masked[:, None, :], NEG_INF, scores)
            probs = torch.softmax(scores.float(), -1).to(scores.dtype)
            attn = torch.einsum(eq_v, probs, v_layer)
            h = h + block.attn.c_proj(attn.reshape(B, self.d_model))
            h = h + block.mlp(block.ln_2(h))
        return self._logits(h), cache

    def compute_loss(self, logits: torch.Tensor, targets: torch.Tensor
                     ) -> torch.Tensor:
        """Cross-entropy ignoring PAD (= n_token - 1)."""
        return masked_cross_entropy(logits, targets, self.n_token - 1)
