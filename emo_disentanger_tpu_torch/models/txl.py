"""Stage-1 model: the Transformer-XL lead-sheet decoder.

Port of ``emo_disentanger_tpu/models/txl.py`` (reference ``PlainTransformer``
+ ``OptimusTXLDecoder``, ``stage1_compose/model/plain_transformer.py``,
``optimus_txl_decoder.py``): relative-position attention with r_w / r_r
biases shared across layers, a fused bias-free QKV projection (q, k, v
along the last dimension in that order), a per-layer position projection,
the rel-shift score layout, pre- or post-LN feed-forward, XL hidden-state
memories for segment recurrence, and the renormalization of the attention
probabilities after attention dropout (``probs / (sum + 1e-8)``, in eval
mode too; ``optimus_txl_decoder.py:363``).

Parameter names are the reference checkpoint's (``word_emb.emb_lookup``,
``decoder.r_w_bias`` / ``decoder.r_r_bias``,
``decoder.layers.{i}.dec_attn.{qkv_net,r_net,o_net,layer_norm}``,
``decoder.layers.{i}.pos_ff.CoreNet.{0,3}`` / ``.pos_ff.layer_norm``,
``dec_out_proj``), so a released state dict loads by name.

Decode.  ``init_decode_cache(layout)`` allocates k/v and the
distance-indexed position heads r once, in one of JAX's three layouts
(``ops.attention``): 'khd' k/v [n_layer, B, Kmax, H, Dh] with r [n_layer,
Kmax, H, Dh], or head-major 'hkd' [n_layer, B, H, Kmax, Dh] / 'dk'
[n_layer, B, H, Dh, Kmax] with r [n_layer, H, Dh, Kmax];
``decode_step`` (one clock for all) and ``decode_step_pe`` (a clock per
element) take the same ``layout`` and write the caches in place.  Weights
are fixed at inference, so caching k/v after the fused projection gives the
reference's recompute-from-mems attention.  In 'khd', ``decode_step`` takes
the chunked live-prefix attention below B=32 and the whole-cache one from
there, as JAX does (``txl.py:437``); the head-major layouts always take the
whole-cache one (``txl.py:429-434``).  ``decode_step_pe``'s row writes and
attention are one ``ops.attention.txl_decode_attention_pe``: on CUDA one
launch of ``csrc/txl_decode_attn.cu`` a layer, which reads each element's
live prefix in any layout.  While a profiler records, each
layer's cache work in a decode step (the k and v row writes and the
relative-position attention, whichever form runs) is the span
``emodis.txl.attn`` (``utils.profiling``), so the device time it launches
can be read whatever implements it.

Tensor parallelism (``parallel.sharding_rules``).  After ``shard_params``
each rank holds n_head / tp heads: ``qkv_net`` (block by block) and
``r_net`` column-parallel, ``o_net`` row-parallel, the feed-forward's
``CoreNet.0`` / ``.3`` column / row, and the vocabulary head column-parallel
with its logits gathered; every projection runs through
``parallel_linear``.  The biases r_w / r_r stay replicated, and the forward
takes this rank's heads of them through ``tp_heads``, whose backward sums
their gradient over tp, so every tp rank holds the whole gradient once.
Hidden states, and so the XL memories, are full width on every rank.  A
tensor-parallel model does not decode: serving shards the batch.

Precision, as the Performer's (``models/performer.py``): the forward
computes in ``compute_dtype`` when given, else in the parameters' dtype;
the decode and its cache follow the parameters' dtype (serving casts them,
``utils.precision.cast_params``).  The softmax and the vocabulary head run
in float32.  Dropout (rate ``dropout``) sits at the JAX sites: the embedding
(twice), the position embedding, the attention probabilities, the attention
output, both feed-forward activations and the final hidden state; it is
active in ``train()`` mode only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (
    NEG_INF, flash_decode_attention, full_decode_attention, layout_equations,
    txl_decode_attention_pe, write_row)
from ..parallel.sharding_rules import parallel_linear, tp_heads
from ..utils.device import resolve_device
from ..utils.profiling import span
from .embeddings import (
    LayerNorm, TokenEmbedding, head_f32, txl_positional_embedding)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift: [B, H, Q, K] -> [B, H, Q, K] so that
    entry (i, j) picks the score at distance (mlen + i - j)."""
    b, h, q, k = x.shape
    x = F.pad(x, (1, 0))
    return x.reshape(b, h, k + 1, q)[:, :, 1:].reshape(b, h, q, k)


def _apply_linear(x, weight, bias):
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def _linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``mod`` applied in ``x``'s dtype (its weights cast to it), with its
    tensor-parallel collectives when it is sharded."""
    return parallel_linear(mod, x, _apply_linear)


class TXLSelfAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_head: int, *,
                 dropout: float = 0.1, dropatt: float = 0.1,
                 pre_lnorm: bool = True, device=None):
        super().__init__()
        self.n_head = n_head
        self.d_head = d_head
        self.pre_lnorm = pre_lnorm
        hd = n_head * d_head
        self.qkv_net = nn.Linear(d_model, 3 * hd, bias=False, device=device)
        self.r_net = nn.Linear(d_model, hd, bias=False, device=device)
        self.o_net = nn.Linear(hd, d_model, bias=False, device=device)
        self.layer_norm = LayerNorm(d_model, device=device)
        self.drop = nn.Dropout(dropout)
        self.dropatt = nn.Dropout(dropatt)

    def forward(self, x, pos_emb, r_w_bias, r_r_bias, attn_mask, mems=None):
        """x [B, Q, D]; pos_emb [K, D] float32; attn_mask [Q, K], True =
        masked; mems [B, mlen, D] or None; r_w_bias / r_r_bias [h, Dh] of
        this rank's h heads (all of them without tensor parallelism)."""
        B, Q, _ = x.shape
        cat = x if mems is None else torch.cat([mems.to(x.dtype), x], 1)
        K = cat.shape[1]
        inp = self.layer_norm(cat) if self.pre_lnorm else cat
        q, k, v = _linear(self.qkv_net, inp).chunk(3, dim=-1)
        h = q.shape[-1] // self.d_head               # this rank's heads
        q = q[:, -Q:].reshape(B, Q, h, self.d_head)
        k = k.reshape(B, K, h, self.d_head)
        v = v.reshape(B, K, h, self.d_head)
        r = _linear(self.r_net, pos_emb.to(x.dtype)).reshape(K, h, self.d_head)
        ac = torch.einsum('bihd,bjhd->bhij', q + r_w_bias.to(q.dtype), k)
        bd = _rel_shift(torch.einsum('bihd,jhd->bhij',
                                     q + r_r_bias.to(q.dtype), r))
        scores = (ac + bd) * (1.0 / self.d_head ** 0.5)
        scores = torch.where(attn_mask[None, None], NEG_INF, scores)
        probs = torch.softmax(scores.float(), -1).to(scores.dtype)
        probs = self.dropatt(probs)
        probs = probs / (probs.sum(-1, keepdim=True) + 1e-8)
        out = torch.einsum('bhij,bjhd->bihd', probs, v).reshape(B, Q, -1)
        out = self.drop(_linear(self.o_net, out))
        return x + out if self.pre_lnorm else self.layer_norm(x + out)

    def _qkv_step(self, x):
        B = x.shape[0]
        inp = self.layer_norm(x) if self.pre_lnorm else x
        q, k, v = _linear(self.qkv_net, inp).chunk(3, dim=-1)
        heads = lambda t: t.reshape(B, self.n_head, self.d_head)  # noqa: E731
        return heads(q), heads(k), heads(v)

    def _out_step(self, x, attn):
        out = _linear(self.o_net, attn.reshape(x.shape[0], 1, -1))
        return x + out if self.pre_lnorm else self.layer_norm(x + out)

    def decode_step(self, x, t: int, k_layer, v_layer, r_heads, r_w_bias,
                    r_r_bias, full_attention: bool = False,
                    layout: str = 'khd'):
        """One token: x [B, 1, D]; writes k/v at position ``t`` of the
        layer's caches ``k_layer`` / ``v_layer`` (in ``layout``) in place
        (clamped to the cache, as JAX clamps) and attends over positions
        0..t.  The chunked attention (``full_attention=False``) reads
        'khd' only."""
        q, k, v = self._qkv_step(x)
        with span('emodis.txl.attn'):
            write_row(k_layer, k, t, layout)
            write_row(v_layer, v, t, layout)
            args = (q + r_w_bias.to(q.dtype), k_layer, v_layer, t)
            kw = dict(scale=1.0 / self.d_head ** 0.5,
                      rel=(q + r_r_bias.to(q.dtype), r_heads))
            attn = (full_decode_attention(*args, layout=layout, **kw)
                    if full_attention else flash_decode_attention(*args, **kw))
        return self._out_step(x, attn)

    def decode_step_pe(self, x, t: torch.Tensor, k_layer, v_layer, r_heads,
                       r_w_bias, r_r_bias, layout: str = 'khd'):
        """:meth:`decode_step` with a per-element clock ``t`` [B]: the row
        writes and the attention are one ``txl_decode_attention_pe`` (on
        CUDA one kernel launch over each element's live prefix)."""
        q, k, v = self._qkv_step(x)
        with span('emodis.txl.attn'):
            attn = txl_decode_attention_pe(
                q, k, v, k_layer, v_layer, t, r_heads, r_w_bias, r_r_bias,
                scale=1.0 / self.d_head ** 0.5, layout=layout)
        return self._out_step(x, attn)

    def rel_heads(self, max_klen: int, dtype: torch.dtype) -> torch.Tensor:
        """r_net(PE(d)) for distances 0..max_klen-1: [max_klen, H, Dh]."""
        pos = torch.arange(max_klen, device=self.r_net.weight.device)
        pe = txl_positional_embedding(pos, self.r_net.in_features)
        return _linear(self.r_net, pe.to(dtype)).reshape(
            max_klen, self.n_head, self.d_head)


class PositionwiseFF(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, dropout: float = 0.1,
                 pre_lnorm: bool = True, device=None):
        super().__init__()
        self.pre_lnorm = pre_lnorm
        self.CoreNet = nn.Sequential(
            nn.Linear(d_model, d_ff, device=device), nn.ReLU(),
            nn.Dropout(dropout), nn.Linear(d_ff, d_model, device=device),
            nn.Dropout(dropout))
        self.layer_norm = LayerNorm(d_model, device=device)

    def forward(self, x, deterministic: bool = False):
        """``deterministic`` skips the dropout (the decode's use)."""
        c = self.CoreNet
        inp = self.layer_norm(x) if self.pre_lnorm else x
        h = F.relu(_linear(c[0], inp))
        h = _linear(c[3], h if deterministic else c[2](h))
        h = h if deterministic else c[4](h)
        return x + h if self.pre_lnorm else self.layer_norm(x + h)


class TXLLayer(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_head: int, d_ff: int, *,
                 dropout: float = 0.1, dropatt: float = 0.1,
                 pre_lnorm: bool = True, device=None):
        super().__init__()
        self.dec_attn = TXLSelfAttention(
            n_head, d_model, d_head, dropout=dropout, dropatt=dropatt,
            pre_lnorm=pre_lnorm, device=device)
        self.pos_ff = PositionwiseFF(d_model, d_ff, dropout=dropout,
                                     pre_lnorm=pre_lnorm, device=device)

    def forward(self, x, pos_emb, r_w_bias, r_r_bias, attn_mask, mems=None):
        return self.pos_ff(self.dec_attn(x, pos_emb, r_w_bias, r_r_bias,
                                         attn_mask, mems))


class TXLDecoder(nn.Module):
    """The layers and the shared relative-position biases (the reference's
    ``decoder`` submodule)."""

    def __init__(self, n_layer: int, n_head: int, d_model: int, d_ff: int, *,
                 dropout: float, pre_lnorm: bool, device=None):
        super().__init__()
        d_head = d_model // n_head
        self.r_w_bias = nn.Parameter(torch.zeros(n_head, d_head, device=device))
        self.r_r_bias = nn.Parameter(torch.zeros(n_head, d_head, device=device))
        self.layers = nn.ModuleList(
            TXLLayer(n_head, d_model, d_head, d_ff, dropout=dropout,
                     dropatt=dropout, pre_lnorm=pre_lnorm, device=device)
            for _ in range(n_layer))


class PlainTransformer(nn.Module):
    """Stage-1 decoder-only LM (reference ``PlainTransformer``)."""

    def __init__(self, vocab_size: int, d_embed: int = 512, n_layer: int = 12,
                 n_head: int = 8, d_model: int = 512, d_ff: int = 2048, *,
                 dropout: float = 0.1, pre_lnorm: bool = True,
                 mem_len: int = 0, pad_id: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = 'cuda',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.vocab_size = vocab_size
        self.n_layer = n_layer
        self.n_head = n_head
        self.d_model = d_model
        self.d_head = d_model // n_head
        self.mem_len = mem_len
        self.pad_id = vocab_size - 1 if pad_id is None else pad_id
        self.compute_dtype = compute_dtype
        self.word_emb = TokenEmbedding(vocab_size, d_embed, d_model,
                                       pad_id=self.pad_id, device=dev)
        self.emb_dropout = nn.Dropout(dropout)
        self.inp_dropout = nn.Dropout(dropout)
        self.pos_dropout = nn.Dropout(dropout)
        self.out_dropout = nn.Dropout(dropout)
        self.decoder = TXLDecoder(n_layer, n_head, d_model, d_ff,
                                  dropout=dropout, pre_lnorm=pre_lnorm,
                                  device=dev)
        self.dec_out_proj = nn.Linear(d_model, vocab_size, device=dev)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.dec_out_proj.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX initialization: N(0, 0.01) weights, embeddings and
        biases r_w / r_r, zero Linear biases, N(1, 0.01) LayerNorm scales,
        drawn on the CPU from ``generator`` (seed 0 when None)."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        randn = lambda p: torch.randn(p.shape, generator=g).to(p)  # noqa: E731
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.copy_(1.0 + 0.01 * randn(mod.weight))
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.copy_(0.01 * randn(mod.weight))
                if getattr(mod, 'bias', None) is not None:
                    mod.bias.zero_()
        for p in (self.decoder.r_w_bias, self.decoder.r_r_bias):
            p.copy_(0.01 * randn(p))

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return parallel_linear(self.dec_out_proj, h, head_f32)

    # ------------------------------------------------------------- train
    def forward(self, tokens: torch.Tensor,
                mems: Optional[List[torch.Tensor]] = None,
                return_hiddens: bool = False):
        """tokens [B, L] -> (logits [B, L, V] float32, new_mems).

        ``mems``: optional n_layer + 1 hidden-state memories [B, mlen, D]
        (XL segment recurrence).  ``new_mems`` (None unless ``mem_len`` >
        0) holds the last ``mem_len`` entries of cat(mems, hiddens) of each of
        the n_layer + 1 hidden states (the embedding and every layer's
        output), detached.  ``return_hiddens`` also returns those hidden
        states [B, L, D] themselves."""
        B, L = tokens.shape
        mlen = mems[0].shape[1] if mems is not None else 0
        klen = mlen + L
        h = self.word_emb(tokens)
        if self.compute_dtype is not None:
            h = h.to(self.compute_dtype)
        h = self.inp_dropout(self.emb_dropout(h))
        pos_seq = torch.arange(klen - 1, -1, -1, device=tokens.device)
        pos_emb = self.pos_dropout(txl_positional_embedding(pos_seq,
                                                            self.d_model))
        i = torch.arange(L, device=tokens.device)[:, None]
        j = torch.arange(klen, device=tokens.device)[None, :]
        attn_mask = j > i + mlen
        dec = self.decoder
        qkv = dec.layers[0].dec_attn.qkv_net
        r_w_bias, r_r_bias = (tp_heads(p, qkv)
                              for p in (dec.r_w_bias, dec.r_r_bias))
        hids = [h]
        for idx, layer in enumerate(dec.layers):
            h = layer(h, pos_emb, r_w_bias, r_r_bias, attn_mask,
                      None if mems is None else mems[idx])
            hids.append(h)
        logits = self._logits(self.out_dropout(h))
        new_mems = None
        if self.mem_len > 0:
            new_mems = []
            for idx in range(self.n_layer + 1):
                cat = hids[idx] if mems is None else torch.cat(
                    [mems[idx].to(hids[idx].dtype), hids[idx]], 1)
                new_mems.append(cat[:, -self.mem_len:].detach())
        if return_hiddens:
            return logits, new_mems, hids
        return logits, new_mems

    # ------------------------------------------------------------ decode
    @property
    def decode_dtype(self) -> torch.dtype:
        return self.decoder.layers[0].dec_attn.qkv_net.weight.dtype

    def init_decode_cache(self, batch: int, max_klen: int,
                          layout: str = 'khd') -> Dict[str, torch.Tensor]:
        """Zero k and v caches and the position heads r (r[i, d] = layer
        i's r_net(PE(d))), in the decode dtype (``txl.py:381-410``):
        'khd' k/v [n_layer, B, Kmax, H, Dh] and r [n_layer, Kmax, H, Dh];
        'hkd' k/v [n_layer, B, H, Kmax, Dh] or 'dk' [n_layer, B, H, Dh,
        Kmax], both with r [n_layer, H, Dh, Kmax].  Pass the same
        ``layout`` to the decode steps."""
        layout_equations(layout)                  # an unknown layout raises
        if getattr(self, 'tp_size', 1) > 1:
            raise NotImplementedError('a tensor-parallel model does not '
                                      'decode; serving shards the batch')
        dt = self.decode_dtype
        H, Dh = self.n_head, self.d_head
        shape = {'khd': (max_klen, H, Dh), 'hkd': (H, max_klen, Dh),
                 'dk': (H, Dh, max_klen)}[layout]
        k = torch.zeros((self.n_layer, batch) + shape, dtype=dt,
                        device=self.device)
        with torch.no_grad():
            r = torch.stack([layer.dec_attn.rel_heads(max_klen, dt)
                             for layer in self.decoder.layers])
        if layout != 'khd':
            r = r.permute(0, 2, 3, 1).contiguous()
        return {'k': k, 'v': torch.zeros_like(k), 'r': r}

    def _embed_step(self, token: torch.Tensor) -> torch.Tensor:
        return self.word_emb(token[:, None]).to(self.decode_dtype)

    def decode_step(self, token: torch.Tensor, t: int,
                    cache: Dict[str, torch.Tensor],
                    full_attention: Optional[bool] = None,
                    layout: str = 'khd',
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """token [B], one host position ``t`` for all -> (logits [B, V]
        float32, cache); the cache (in ``layout``) is written in place.
        ``full_attention=None`` picks, in 'khd', the whole-cache attention
        from B=32 and the chunked live-prefix one below; the head-major
        layouts take the whole-cache one and refuse
        ``full_attention=False``."""
        if layout in ('dk', 'hkd'):
            if full_attention is False:
                raise ValueError(
                    f'layout {layout!r} stores the cache head-major, which '
                    'only the whole-cache attention reads; '
                    "full_attention=False (chunked) needs layout='khd'")
            full_attention = True
        elif full_attention is None:
            full_attention = token.shape[0] >= 32
        h = self._embed_step(token)
        dec = self.decoder
        for i, layer in enumerate(dec.layers):
            h = layer.dec_attn.decode_step(
                h, t, cache['k'][i], cache['v'][i], cache['r'][i],
                dec.r_w_bias, dec.r_r_bias, full_attention=full_attention,
                layout=layout)
            h = layer.pos_ff(h, deterministic=True)
        return self._logits(h)[:, 0], cache

    def decode_step_pe(self, token: torch.Tensor, t: torch.Tensor,
                       cache: Dict[str, torch.Tensor], layout: str = 'khd',
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """:meth:`decode_step` with per-element positions ``t`` [B] (the
        continuous-batching decode, whole-cache attention in any layout;
        positions past the cache clamp to its last row)."""
        h = self._embed_step(token)
        dec = self.decoder
        for i, layer in enumerate(dec.layers):
            h = layer.dec_attn.decode_step_pe(
                h, t, cache['k'][i], cache['v'][i], cache['r'][i],
                dec.r_w_bias, dec.r_r_bias, layout=layout)
            h = layer.pos_ff(h, deterministic=True)
        return self._logits(h)[:, 0], cache

    # -------------------------------------------------------------- loss
    def compute_loss(self, logits: torch.Tensor, targets: torch.Tensor
                     ) -> torch.Tensor:
        """Mean CE over non-PAD targets (``plain_transformer.py:82-93``)."""
        return masked_cross_entropy(logits, targets, self.pad_id)


def update_mems_varlen(mems: torch.Tensor, hids: torch.Tensor,
                       seg_len: torch.Tensor) -> torch.Tensor:
    """Per-sample variable-length XL memory update (``txl.py:469-493``).

    ``mems`` [B, mlen, D], ``hids`` [B, L, D], ``seg_len`` [B]: each sample
    keeps the last mlen entries of cat(mems_b, hids_b[:seg_len_b]) (the
    reference's ``_update_mems`` dec_seg_len path in a fixed-shape buffer;
    the zero prefix of a fresh buffer stands for its zero left-padding).
    Detached."""
    B, mlen, D = mems.shape
    L = hids.shape[1]
    n = seg_len.clamp(0, L).long()
    idx = n[:, None] + torch.arange(mlen, device=mems.device)[None, :]
    gather = lambda src, rows: src.gather(  # noqa: E731
        1, rows[..., None].expand(B, mlen, D))
    old = gather(mems, idx.clamp(0, mlen - 1))
    new = gather(hids.to(mems.dtype), (idx - mlen).clamp(0, L - 1))
    return torch.where((idx < mlen)[..., None], old, new).detach()


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         pad_id: int) -> torch.Tensor:
    """Mean negative log-likelihood over the non-PAD targets, in float32
    (``models/txl.py:496-502``); 0 when every target is PAD."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    mask = (targets != pad_id).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
