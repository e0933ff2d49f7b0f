"""The stage-1 Transformer-XL's weights, made from the seed, under the
port's (the reference checkpoint's) parameter names; the program and the
plain reference are handed the same values.

As ``inputs.make_weights``: drawn on the device from a ``torch.Generator``
there, in one call, then cut into the parameters by the reference's list of
names and shapes (``reference.txl.param_shapes``): N(0, 0.01) matrices,
embeddings and the shared biases r_w, r_r, N(1, 0.01) LayerNorm scales,
zero biases.  A serving cell rounds them to the type they are served in.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional

import torch

from .reference import txl
from .traffic_txl import LEAD_GRAMMAR


def make_weights(cfg: dict, vocab: int, seed: int, device,
                 grammar: Optional[dict] = None,
                 e2w: Optional[Dict[str, int]] = None,
                 served_dtype: Optional[torch.dtype] = None
                 ) -> 'OrderedDict[str, torch.Tensor]':
    """Every parameter, float32 on ``device``, from ``seed``; with
    ``grammar`` (the config's ``head_grammar``) the head follows
    ``LEAD_GRAMMAR``; with ``served_dtype`` the values are rounded to it."""
    shapes = txl.param_shapes(cfg, vocab)
    sizes = [math.prod(s) for s, _ in shapes.values()]
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=g, device=device)
    out, o = OrderedDict(), 0
    for (name, (shape, kind)), n in zip(shapes.items(), sizes):
        part = z[o:o + n].view(shape)
        o += n
        if kind == 'normal':
            out[name] = 0.01 * part
        elif kind == 'ln':
            out[name] = 1.0 + 0.01 * part
        else:
            out[name] = torch.zeros(shape, device=device)
    if grammar is not None:
        value_path(out, cfg, grammar['value_out_gain'])
        lead_grammar(out, cfg, grammar, e2w, g)
    if served_dtype is not None:
        for name in out:
            out[name] = out[name].to(served_dtype).float()
    return out


@torch.no_grad()
def value_path(P: dict, cfg: dict, gain: float) -> None:
    """Draw the value rows of ``qkv_net`` and ``o_net`` at ``gain /
    sqrt(d_model)`` in place of 0.01, so that attention moves the hidden
    state and a served token hangs on the whole prefix through the cache;
    q, k and the position heads keep 0.01."""
    D = cfg['d_model']
    k = gain / D ** 0.5 / 0.01
    for name, w in P.items():
        if name.endswith('dec_attn.o_net.weight'):
            w.mul_(k)
        elif name.endswith('dec_attn.qkv_net.weight'):
            w[2 * D:].mul_(k)


@torch.no_grad()
def lead_grammar(P: dict, cfg: dict, grammar: dict, e2w: Dict[str, int],
                 g: torch.Generator) -> None:
    """Give a random model a head that follows ``LEAD_GRAMMAR``: the token
    table's rows made orthonormal (the QR factor of the random draw, so no
    two events' embeddings overlap) and scaled so that each embedded token
    (the table times sqrt(d_model)) has the norm ``emb_norm``; the head's
    row of each event the sum of the unit embeddings of the events that
    allow it, scaled so that an allowed event's logit is about ``logit``,
    plus Gaussian noise of about ``noise_logit`` a logit, which breaks the
    ties between the events one event allows by the whole hidden state.
    The head reads the residual stream (no final LayerNorm), and every
    layer's output matrices are projected off the embeddings' span, so the
    grammar's logits read the current token's embedding alone while the
    prefix, through attention, moves the noise's ties.  Needs a vocabulary
    smaller than d_model."""
    D = cfg['d_model']
    w = P['word_emb.emb_lookup.weight']
    if w.shape[0] >= D:
        raise ValueError(f'orthonormal embeddings need vocab {w.shape[0]} '
                         f'< d_model {D}')
    norm = grammar['emb_norm']
    unit = torch.linalg.qr(w.t())[0].t()
    P['word_emb.emb_lookup.weight'] = unit * (norm / D ** 0.5)
    gain = grammar['logit'] / norm
    head = torch.randn(P['dec_out_proj.weight'].shape, generator=g,
                       device=w.device) * (grammar['noise_logit'] / norm)
    for src, allowed in LEAD_GRAMMAR.items():
        for ev in allowed:
            head[e2w[ev]] += gain * unit[e2w[src]]
    P['dec_out_proj.weight'] = head
    P['dec_out_proj.bias'] = torch.zeros_like(P['dec_out_proj.bias'])
    # each layer writes outside the embeddings' span: the grammar's rows see
    # the current token alone, and the prefix moves only the near ties
    off_span = torch.eye(D, device=w.device) - unit.t() @ unit
    for i in range(cfg['n_layer']):
        for name in ('dec_attn.o_net.weight', 'pos_ff.CoreNet.3.weight',
                     'pos_ff.CoreNet.3.bias'):
            key = f'decoder.layers.{i}.{name}'
            P[key] = off_span @ P[key]
