"""Plain float32 references of the two stage-2 models, for the check that
decides ``correct``.

Plain PyTorch only: no kernel, no cache, no batching tricks, and nothing of
the measured program.  They follow the published description
(EMO-Disentanger, arXiv 2407.20955, stage 2; the reference PyTorch code's
``music_performer.py`` and its GPT-2 option):

* embedding: token table times sqrt(d_model), plus the segment table times
  sqrt(d_model), plus interleaved sinusoids (sin on even features, cos on
  odd), then dropout;
* Performer: post-norm blocks, attn -> dropout -> add -> LayerNorm -> ReLU FF
  (dropout after the ReLU and after the second matrix) -> add -> LayerNorm;
  FAVOR+ causal linear attention as published: positive features
  phi(x) = exp(w^T x' - |x'|^2 / 2) / sqrt(M), x' = x d_head^(-1/4), the
  query's max over features subtracted, the key's stabilizer 0, and
  out_i = sum_{j<=i} phi_q_i . phi_k_j v_j / (sum_{j<=i} phi_q_i . phi_k_j
  + 1e-6);
* GPT-2: pre-norm blocks, causal softmax attention scaled by d_head^-1/2
  with dropout on the probabilities, tanh-GELU MLP, dropout on each block
  output, no final LayerNorm;
* the vocabulary head, and the cross-entropy mean over non-PAD targets.

Departures, noted: the features keep no additive epsilon (the port's
definition, ``phi`` exactly as above); a stabilizer that is one scalar per
row of keys cancels in the ratio up to the 1e-6 term, so the program's key
max and this key stabilizer 0 agree to that term.

``drop(site, x)`` applies dropout site by site in the model's order (or
nothing); ``quant(x)`` rounds every matrix product's operands (the control
computes in a lower precision through it).  Both default to identity.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
_ident = lambda x: x


def param_shapes(cfg: dict, vocab: int) -> 'OrderedDict[str, tuple]':
    """Every parameter under the reference checkpoint's name, with its shape
    and how it is initialised ('normal': N(0, 0.01); 'ln': N(1, 0.01);
    'zero')."""
    D, F_, L = cfg['d_model'], cfg['d_ff'], cfg['n_layer']
    out = OrderedDict()
    out['token_emb.emb_lookup.weight'] = ((vocab, D), 'normal')
    out['segemb.emb_lookup.weight'] = ((cfg['n_segment_types'], D), 'normal')
    for i in range(L):
        if cfg['kind'] == 'performer':
            p = f'transformer_decoder.decoder_layers.{i}.'
            for name in ('query', 'key', 'value', 'out'):
                out[f'{p}attention.{name}_projection.weight'] = ((D, D), 'normal')
                out[f'{p}attention.{name}_projection.bias'] = ((D,), 'zero')
            out[p + 'linear1.weight'] = ((F_, D), 'normal')
            out[p + 'linear1.bias'] = ((F_,), 'zero')
            out[p + 'linear2.weight'] = ((D, F_), 'normal')
            out[p + 'linear2.bias'] = ((D,), 'zero')
            for n in ('norm1', 'norm2'):
                out[f'{p}{n}.weight'] = ((D,), 'ln')
                out[f'{p}{n}.bias'] = ((D,), 'zero')
        else:
            p = f'transformer_decoder.{i}.'
            out[p + 'ln_1.weight'] = ((D,), 'ln')
            out[p + 'ln_1.bias'] = ((D,), 'zero')
            out[p + 'attn.c_attn.weight'] = ((D, 3 * D), 'normal')
            out[p + 'attn.c_attn.bias'] = ((3 * D,), 'zero')
            out[p + 'attn.c_proj.weight'] = ((D, D), 'normal')
            out[p + 'attn.c_proj.bias'] = ((D,), 'zero')
            out[p + 'ln_2.weight'] = ((D,), 'ln')
            out[p + 'ln_2.bias'] = ((D,), 'zero')
            out[p + 'mlp.c_fc.weight'] = ((D, F_), 'normal')
            out[p + 'mlp.c_fc.bias'] = ((F_,), 'zero')
            out[p + 'mlp.c_proj.weight'] = ((F_, D), 'normal')
            out[p + 'mlp.c_proj.bias'] = ((D,), 'zero')
    out['dec_out_proj.weight'] = ((vocab, D), 'normal')
    out['dec_out_proj.bias'] = ((vocab,), 'zero')
    return out


def positions(n: int, d: int, device) -> torch.Tensor:
    """[n, d] interleaved sinusoids, in float32 as the reference computes
    the frequency step."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    step = -torch.log(torch.tensor(10000.0, device=device)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * step)
    pe = torch.zeros(n, d, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _linear(x, w, b, quant, conv1d=False):
    """x @ W^T + b (torch layout) or x @ W + b (GPT-2's Conv1D layout)."""
    w = w if conv1d else w.t()
    return quant(x) @ quant(w) + b


def layer_norm(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g, b, 1e-5)


def embed(P: Params, tokens, seg):
    D = P['token_emb.emb_lookup.weight'].shape[1]
    scale = math.sqrt(D)
    h = (P['token_emb.emb_lookup.weight'][tokens] * scale
         + P['segemb.emb_lookup.weight'][seg] * scale)
    return h + positions(tokens.shape[1], D, tokens.device)


def favor_features(x, omega, is_query: bool, quant=_ident):
    """phi(x) [.., L, M] for x [.., L, Dh] (see the module docstring)."""
    M = omega.shape[-1]
    xs = x * x.shape[-1] ** -0.25
    h = quant(xs) @ quant(omega) - 0.5 * (xs * xs).sum(-1, keepdim=True)
    if is_query:
        h = h - h.amax(-1, keepdim=True).detach()
    return torch.exp(h) / math.sqrt(M)


def favor_attention(q, k, v, omega, quant=_ident, chunk: int = 256):
    """Causal FAVOR+ over [B, H, L, Dh] q, k, v: the same sum as the
    masked L x L product, taken a chunk of ``chunk`` positions at a time
    with the running sums S = sum phi_k v^T and z = sum phi_k carried
    between chunks."""
    pq = favor_features(q, omega, True, quant)
    pk = favor_features(k, omega, False, quant)
    B, H, L, M = pq.shape
    S = pq.new_zeros(B, H, M, v.shape[-1])
    z = pq.new_zeros(B, H, M)
    outs = []
    for c0 in range(0, L, chunk):
        a, b, vv = pq[:, :, c0:c0 + chunk], pk[:, :, c0:c0 + chunk], v[:, :, c0:c0 + chunk]
        n = a.shape[2]
        tri = torch.ones(n, n, device=q.device).tril()
        intra = (quant(a) @ quant(b).transpose(-1, -2)) * tri
        num = intra @ quant(vv) + quant(a) @ quant(S)
        den = intra.sum(-1) + (a * z[:, :, None]).sum(-1)
        outs.append(num / (den[..., None] + 1e-6))
        S = S + quant(b).transpose(-1, -2) @ quant(vv)
        z = z + b.sum(2)
    return torch.cat(outs, dim=2)


def performer_forward(P: Params, cfg: dict, tokens, seg, omegas,
                      drop: Callable = None, quant: Callable = _ident):
    """tokens, seg [B, L] -> logits [B, L, V]; omegas [n_layer, Dh, M]."""
    drop = drop or (lambda site, x: x)
    H = cfg['n_head']
    x = drop(0, embed(P, tokens, seg))
    B, L, D = x.shape
    heads = lambda t: t.reshape(B, L, H, D // H).transpose(1, 2)
    for i in range(cfg['n_layer']):
        p = f'transformer_decoder.decoder_layers.{i}.'
        lin = lambda t, n: _linear(t, P[p + n + '.weight'], P[p + n + '.bias'], quant)
        q = lin(x, 'attention.query_projection')
        k = lin(x, 'attention.key_projection')
        v = lin(x, 'attention.value_projection')
        a = favor_attention(heads(q), heads(k), heads(v), omegas[i], quant)
        a = a.transpose(1, 2).reshape(B, L, D)
        x = x + drop(1 + 3 * i, lin(a, 'attention.out_projection'))
        x = layer_norm(x, P[p + 'norm1.weight'], P[p + 'norm1.bias'])
        y = drop(2 + 3 * i, torch.relu(lin(x, 'linear1')))
        y = drop(3 + 3 * i, lin(y, 'linear2'))
        x = layer_norm(x + y, P[p + 'norm2.weight'], P[p + 'norm2.bias'])
    return _linear(x, P['dec_out_proj.weight'], P['dec_out_proj.bias'], quant)


def performer_drop_shapes(cfg: dict, B: int, L: int):
    """The dropout sites of a Performer forward, in order: the embedding,
    then each layer's attention output, ReLU output and FF output."""
    D, F_ = cfg['d_model'], cfg['d_ff']
    out = [(B, L, D)]
    for _ in range(cfg['n_layer']):
        out += [(B, L, D), (B, L, F_), (B, L, D)]
    return out


def gpt2_forward(P: Params, cfg: dict, tokens, seg, drop: Callable = None,
                 quant: Callable = _ident):
    """tokens, seg [B, L] -> logits [B, L, V]."""
    drop = drop or (lambda site, x: x)
    H = cfg['n_head']
    x = drop(0, embed(P, tokens, seg))
    B, L, D = x.shape
    Dh = D // H
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    for i in range(cfg['n_layer']):
        p = f'transformer_decoder.{i}.'
        lin = lambda t, n: _linear(t, P[p + n + '.weight'], P[p + n + '.bias'],
                                   quant, conv1d=True)
        qkv = lin(layer_norm(x, P[p + 'ln_1.weight'], P[p + 'ln_1.bias']),
                  'attn.c_attn')
        q, k, v = (t.reshape(B, L, H, Dh).transpose(1, 2)
                   for t in qkv.split(D, -1))
        s = (quant(q) @ quant(k).transpose(-1, -2)) / math.sqrt(Dh)
        s = s.masked_fill(~mask, float('-inf'))
        pr = drop(1 + 3 * i, torch.softmax(s, -1))
        a = (quant(pr) @ quant(v)).transpose(1, 2).reshape(B, L, D)
        x = x + drop(2 + 3 * i, lin(a, 'attn.c_proj'))
        y = lin(layer_norm(x, P[p + 'ln_2.weight'], P[p + 'ln_2.bias']), 'mlp.c_fc')
        y = lin(F.gelu(y, approximate='tanh'), 'mlp.c_proj')
        x = x + drop(3 + 3 * i, y)
    return _linear(x, P['dec_out_proj.weight'], P['dec_out_proj.bias'], quant)


def gpt2_drop_shapes(cfg: dict, B: int, L: int):
    """The dropout sites of a GPT-2 forward, in order: the embedding, then
    each block's attention probabilities, attention output and MLP output."""
    D, H = cfg['d_model'], cfg['n_head']
    out = [(B, L, D)]
    for _ in range(cfg['n_layer']):
        out += [(B, H, L, L), (B, L, D), (B, L, D)]
    return out


def forward(P: Params, cfg: dict, tokens, seg, omegas=None,
            drop: Optional[Callable] = None, quant: Callable = _ident):
    if cfg['kind'] == 'performer':
        return performer_forward(P, cfg, tokens, seg, omegas, drop, quant)
    return gpt2_forward(P, cfg, tokens, seg, drop, quant)


def drop_shapes(cfg: dict, B: int, L: int):
    if cfg['kind'] == 'performer':
        return performer_drop_shapes(cfg, B, L)
    return gpt2_drop_shapes(cfg, B, L)


def nll_sum(logits, targets, pad_id: int):
    """(sum of the non-PAD targets' negative log-likelihoods, their count)."""
    logp = F.log_softmax(logits, -1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    mask = (targets != pad_id).to(logits.dtype)
    return (nll * mask).sum(), mask.sum()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude at 448), gradient passed straight through: the control's
    matrix-product operands."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    r = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (r - x).detach()


def draw_features(d_head: int, m: int, generator: torch.Generator
                  ) -> torch.Tensor:
    """FAVOR+'s random features omega [d_head, m], float32: blocks of
    orthogonalised Gaussians (QR, with the Haar sign correction) whose rows
    take chi-distributed norms, drawn from ``generator`` in this order."""
    dev = generator.device
    blocks = []
    for _ in range(-(-m // d_head)):
        g = torch.randn(d_head, d_head, generator=generator, device=dev)
        q, r = torch.linalg.qr(g)
        blocks.append((q * torch.sign(torch.diagonal(r))[None, :]).T)
    w = torch.cat(blocks, dim=0)[:m]
    norms = torch.randn(m, d_head, generator=generator,
                        device=dev).pow(2).sum(-1, keepdim=True).sqrt()
    return (w * norms).T.contiguous()
