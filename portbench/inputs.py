"""The inputs both sides get: weights and FAVOR+ features made from the
seed.  The program and the plain reference are handed the same values; the
reference never reads anything the program made.

Weights are drawn on the device from a ``torch.Generator`` there, in one
call, then cut into the parameters by the reference's list of names and
shapes: N(0, 0.01) matrices and embeddings, N(1, 0.01) LayerNorm scales,
zero biases (the reference initialisation).  A serving cell rounds them to
the type they are served in, so both sides read the same numbers.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional

import torch

from .reference import models
from .traffic import NOTE_GRAMMAR


def make_weights(cfg: dict, vocab: int, seed: int, device,
                 grammar: Optional[dict] = None,
                 e2w: Optional[Dict[str, int]] = None,
                 served_dtype: Optional[torch.dtype] = None
                 ) -> 'OrderedDict[str, torch.Tensor]':
    """Every parameter, float32 on ``device``, from ``seed``; with
    ``grammar`` (the config's ``head_grammar``) the head follows
    ``NOTE_GRAMMAR``; with ``served_dtype`` the values are rounded to it."""
    shapes = models.param_shapes(cfg, vocab)
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
        note_grammar(out, cfg, grammar, e2w, g)
    if served_dtype is not None:
        for name in out:
            out[name] = out[name].to(served_dtype).float()
    return out


@torch.no_grad()
def value_path(P: dict, cfg: dict, gain: float) -> None:
    """Draw the value and output projections at ``gain / sqrt(d_model)``
    in place of 0.01, so that attention moves the hidden state as in a
    trained model and a served token hangs on the whole prefix through the
    decode state or cache; q and k keep 0.01, so the attention weights stay
    near the prefix mean."""
    D = cfg['d_model']
    k = gain / D ** 0.5 / 0.01
    for name, w in P.items():
        if name.endswith(('value_projection.weight', 'out_projection.weight',
                          'attn.c_proj.weight')):
            w.mul_(k)
        elif name.endswith('attn.c_attn.weight'):
            w[:, 2 * D:].mul_(k)


@torch.no_grad()
def note_grammar(P: dict, cfg: dict, grammar: dict, e2w: Dict[str, int],
                 g: torch.Generator):
    """Give a random model a head that follows ``NOTE_GRAMMAR``, so that its
    songs hold notes: the token embeddings rescaled to ``emb_over_pe``
    times the sinusoids' norm, the head's row of each event the sum of the
    unit (mean-free) embeddings of the events that allow it, scaled so an
    allowed event's logit is about ``logit``, plus Gaussian noise of about
    ``noise_logit`` a logit, which breaks the ties between the events one
    event allows by the whole hidden state.  The head reads a post-norm
    state of norm ~sqrt(d_model) (``reads: post_norm``, the Performer) or
    the residual stream, which the rescaled embedding dominates
    (``reads: residual``, GPT-2)."""
    D = cfg['d_model']
    w = P['token_emb.emb_lookup.weight']
    target = grammar['emb_over_pe'] * (D / 2) ** 0.5
    w.mul_(target / (w.norm(dim=1, keepdim=True) * D ** 0.5))
    unit = w - w.mean(1, keepdim=True)
    unit = unit / unit.norm(dim=1, keepdim=True)
    norm = target if grammar['reads'] == 'residual' else D ** 0.5
    gain = grammar['logit'] / norm
    head = torch.randn(P['dec_out_proj.weight'].shape, generator=g,
                       device=w.device) * (grammar['noise_logit'] / norm)
    for src, allowed in NOTE_GRAMMAR.items():
        for ev in allowed:
            head[e2w[ev]] += gain * unit[e2w[src]]
    P['dec_out_proj.weight'] = head
    P['dec_out_proj.bias'] = torch.zeros_like(P['dec_out_proj.bias'])


def initial_omegas(cfg: dict, seed: int, device) -> torch.Tensor:
    """[n_layer, d_head, M] float32 features from a host generator."""
    g = torch.Generator().manual_seed(seed)
    Dh = cfg['d_model'] // cfg['n_head']
    return torch.stack([models.draw_features(Dh, cfg['n_features'], g)
                        for _ in range(cfg['n_layer'])]).to(device)
