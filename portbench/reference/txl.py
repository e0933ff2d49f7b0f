"""Plain float32 reference of the stage-1 Transformer-XL, for the check that
decides ``correct`` in the stage-1 cells.

Plain PyTorch only: no kernel, no cache, no batching tricks, and nothing of
the measured program.  It follows the published model (Transformer-XL, Dai
et al., arXiv 1901.02860, as EMO-Disentanger's stage 1 configures it: the
reference code's ``plain_transformer.py`` over ``optimus_txl_decoder.py``,
pre-LN, ``mem_len`` 0) over one whole stream:

* embedding: token table times sqrt(d_model) (``AdaptiveEmbedding`` with
  d_embed = d_model, so no projection);
* positions klen - 1, ..., 0 as [sin | cos] halves with inverse frequencies
  1 / 10000^(2i / d_model), through each layer's bias-free ``r_net``;
* each layer: h + o_net(attn(LN(h))), then h + W2 relu(W1 LN(h) + b1) + b2;
  attention from a fused bias-free ``qkv_net`` (q, k, v in that order),
  scores ((q + r_w) . k + rel_shift((q + r_r) . r)) / sqrt(d_head), with
  r_w and r_r shared by every layer, the causal mask, the softmax, the
  probabilities renormalised by ``p / (sum p + 1e-8)``, then p v;
* no final LayerNorm; the vocabulary head ``dec_out_proj`` with its bias.

Departures from ``optimus_txl_decoder.py``, noted: no dropout (inference);
no memories (``mem_len`` 0, one segment of the whole stream, so klen is the
stream's length); the causal mask fills -inf before the softmax where the
published code fills a large negative number, which gives the same
probabilities; the PAD row of the table is not zeroed (no stream holds PAD).

``quant(x)`` rounds every matrix product's operands (the control computes in
a lower precision through it); it defaults to identity.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .models import _ident

Params = Dict[str, torch.Tensor]


def param_shapes(cfg: dict, vocab: int) -> 'OrderedDict[str, tuple]':
    """Every parameter under the reference checkpoint's name, with its shape
    and how it is initialised ('normal': N(0, 0.01); 'ln': N(1, 0.01);
    'zero'), as the reference initialises the model (r_w and r_r included
    in 'normal')."""
    D, F_, H = cfg['d_model'], cfg['d_ff'], cfg['n_head']
    out = OrderedDict()
    out['word_emb.emb_lookup.weight'] = ((vocab, D), 'normal')
    out['decoder.r_w_bias'] = ((H, D // H), 'normal')
    out['decoder.r_r_bias'] = ((H, D // H), 'normal')
    for i in range(cfg['n_layer']):
        p = f'decoder.layers.{i}.'
        out[p + 'dec_attn.qkv_net.weight'] = ((3 * D, D), 'normal')
        out[p + 'dec_attn.r_net.weight'] = ((D, D), 'normal')
        out[p + 'dec_attn.o_net.weight'] = ((D, D), 'normal')
        out[p + 'dec_attn.layer_norm.weight'] = ((D,), 'ln')
        out[p + 'dec_attn.layer_norm.bias'] = ((D,), 'zero')
        out[p + 'pos_ff.CoreNet.0.weight'] = ((F_, D), 'normal')
        out[p + 'pos_ff.CoreNet.0.bias'] = ((F_,), 'zero')
        out[p + 'pos_ff.CoreNet.3.weight'] = ((D, F_), 'normal')
        out[p + 'pos_ff.CoreNet.3.bias'] = ((D,), 'zero')
        out[p + 'pos_ff.layer_norm.weight'] = ((D,), 'ln')
        out[p + 'pos_ff.layer_norm.bias'] = ((D,), 'zero')
    out['dec_out_proj.weight'] = ((vocab, D), 'normal')
    out['dec_out_proj.bias'] = ((vocab,), 'zero')
    return out


def positions(klen: int, d: int, device) -> torch.Tensor:
    """[klen, d] float32 [sin | cos] of the positions klen - 1, ..., 0."""
    pos = torch.arange(klen - 1, -1, -1, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (10000 ** (torch.arange(0.0, d, 2.0, device=device) / d))
    ang = pos[:, None] * inv_freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """The published relative shift of [B, H, Q, K] scores: a zero column
    in front, the matrix read as [K + 1, Q], its first row dropped, read
    back as [Q, K]; entry (i, j) then holds the score at distance
    (K - Q) + i - j, for j <= i + K - Q."""
    b, h, q, k = x.shape
    x = torch.cat([x.new_zeros(b, h, q, 1), x], dim=-1)
    return x.view(b, h, k + 1, q)[:, :, 1:].reshape(b, h, q, k)


def _lin(x, w, quant, b=None):
    y = quant(x) @ quant(w.t())
    return y if b is None else y + b


def forward(P: Params, cfg: dict, tokens: torch.Tensor,
            quant: Callable = _ident) -> torch.Tensor:
    """tokens [B, L] -> logits [B, L, V], float32."""
    D, H = cfg['d_model'], cfg['n_head']
    Dh = D // H
    B, L = tokens.shape
    dev = tokens.device
    h = P['word_emb.emb_lookup.weight'][tokens] * math.sqrt(D)
    pos = positions(L, D, dev)
    mask = torch.ones(L, L, dtype=torch.bool, device=dev).triu(1)
    r_w, r_r = P['decoder.r_w_bias'], P['decoder.r_r_bias']
    for i in range(cfg['n_layer']):
        p = f'decoder.layers.{i}.'
        x = F.layer_norm(h, (D,), P[p + 'dec_attn.layer_norm.weight'],
                         P[p + 'dec_attn.layer_norm.bias'], 1e-5)
        q, k, v = (t.reshape(B, L, H, Dh) for t in
                   _lin(x, P[p + 'dec_attn.qkv_net.weight'], quant).split(D, -1))
        r = _lin(pos, P[p + 'dec_attn.r_net.weight'], quant).reshape(L, H, Dh)
        ac = torch.einsum('bihd,bjhd->bhij', quant(q + r_w), quant(k))
        bd = rel_shift(torch.einsum('bihd,jhd->bhij', quant(q + r_r), quant(r)))
        s = ((ac + bd) / math.sqrt(Dh)).masked_fill(mask, float('-inf'))
        pr = torch.softmax(s, -1)
        pr = pr / (pr.sum(-1, keepdim=True) + 1e-8)
        a = torch.einsum('bhij,bjhd->bihd', quant(pr), quant(v)).reshape(B, L, D)
        h = h + _lin(a, P[p + 'dec_attn.o_net.weight'], quant)
        y = F.layer_norm(h, (D,), P[p + 'pos_ff.layer_norm.weight'],
                         P[p + 'pos_ff.layer_norm.bias'], 1e-5)
        y = torch.relu(_lin(y, P[p + 'pos_ff.CoreNet.0.weight'], quant,
                            P[p + 'pos_ff.CoreNet.0.bias']))
        h = h + _lin(y, P[p + 'pos_ff.CoreNet.3.weight'], quant,
                     P[p + 'pos_ff.CoreNet.3.bias'])
    return _lin(h, P['dec_out_proj.weight'], quant, P['dec_out_proj.bias'])


@torch.no_grad()
def chosen_gaps(P: Params, cfg: dict, songs: List[dict],
                quant: Callable = _ident, control: bool = False,
                device='cpu') -> np.ndarray:
    """The gap by which each chosen token's logit lies below the best logit
    of the plain float32 model, at every position past the primer of
    ``songs`` (dicts with 'stream', the token ids, and 'primer_len'): in
    stage 1 every token after the primer is the model's choice.  With
    ``quant`` the model computes in a lower precision, and with ``control``
    the gap is that of the token it puts first, still read off the float32
    model.  The caller turns TF32 off, as the stage-2 drivers do."""
    gaps = []
    for song in songs:
        tok = torch.tensor([song['stream']], device=device)
        ref = forward(P, cfg, tok)[0].double()
        pick = tok[0, 1:]
        if control:
            pick = forward(P, cfg, tok, quant)[0].argmax(-1)[:-1]
        lo = ref[:-1]
        gap = lo.max(-1).values - lo.gather(-1, pick[:, None])[:, 0]
        gaps.append(gap[song['primer_len'] - 1:].cpu().numpy())
    return np.concatenate(gaps) if gaps else np.zeros(0)
