"""Weight bridge: flax parameters -> this port's state dicts.

The inverses of ``convert_stage1_pt``, ``convert_performer_pt`` and
``convert_gpt2_pt`` in the JAX package (``train/convert_pt.py:31-118``),
under the reference checkpoints' names: a ``LayerNorm_0`` ``scale`` / ``bias`` pair becomes
``weight`` / ``bias``; a flax Dense ``kernel`` [in, out] becomes a torch
``nn.Linear`` ``weight`` [out, in], except in the GPT-2 blocks, whose HF
``Conv1D`` weights keep the [in, out] layout.

A JAX gradient tree has the parameter tree's structure, so the same
functions map ``jax.grad`` of a flax loss onto the port's parameter names
(the tests hold the port's gradients against JAX's that way).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_PROJ = (('q_proj', 'attention.query_projection'),
         ('k_proj', 'attention.key_projection'),
         ('v_proj', 'attention.value_projection'),
         ('out_proj', 'attention.out_projection'),
         ('linear1', 'linear1'),
         ('linear2', 'linear2'))
_GPT2_DENSE = (('c_attn', 'attn.c_attn'), ('attn_proj', 'attn.c_proj'),
               ('c_fc', 'mlp.c_fc'), ('mlp_proj', 'mlp.c_proj'))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _embeddings_and_head(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The token and segment embeddings and the vocabulary head, which both
    stage-2 models name alike."""
    sd = {'token_emb.emb_lookup.weight': _t(p['token_emb']['embedding']),
          'dec_out_proj.weight': _t(p['out_proj']['kernel']).T.contiguous(),
          'dec_out_proj.bias': _t(p['out_proj']['bias'])}
    if 'proj' in p['token_emb']:
        sd['token_emb.proj.weight'] = _t(
            p['token_emb']['proj']['kernel']).T.contiguous()
    if 'segemb' in p:
        sd['segemb.emb_lookup.weight'] = _t(p['segemb']['embedding'])
        if 'proj' in p['segemb']:
            sd['segemb.proj.weight'] = _t(
                p['segemb']['proj']['kernel']).T.contiguous()
    return sd


def _layer_norm(sd: Dict[str, torch.Tensor], name: str, src) -> None:
    sd[f'{name}.weight'] = _t(src['LayerNorm_0']['scale'])
    sd[f'{name}.bias'] = _t(src['LayerNorm_0']['bias'])


def flax_performer_to_torch(params: Dict[str, Any], n_layer: int
                            ) -> Dict[str, torch.Tensor]:
    """``params`` is the ``{'params': {...}}`` tree flax's ``init`` returns
    (or a gradient tree of the same structure), as nested dicts of numpy
    arrays; returns a float32 CPU state dict for
    ``MusicPerformer.load_state_dict`` (cast afterwards for bf16 serving)."""
    p = params['params']
    sd = _embeddings_and_head(p)
    for i in range(n_layer):
        src = p[f'layer_{i}']
        dst = f'transformer_decoder.decoder_layers.{i}'
        for flax_name, torch_name in _PROJ:
            sd[f'{dst}.{torch_name}.weight'] = _t(
                src[flax_name]['kernel']).T.contiguous()
            sd[f'{dst}.{torch_name}.bias'] = _t(src[flax_name]['bias'])
        for norm in ('norm1', 'norm2'):
            _layer_norm(sd, f'{dst}.{norm}', src[norm])
    return sd


def flax_gpt2_to_torch(params: Dict[str, Any], n_layer: int
                       ) -> Dict[str, torch.Tensor]:
    """Like :func:`flax_performer_to_torch`, for ``MusicGPT2``: the blocks'
    Dense kernels go over untransposed (``Conv1D`` [in, out])."""
    p = params['params']
    sd = _embeddings_and_head(p)
    for i in range(n_layer):
        src = p[f'block_{i}']
        dst = f'transformer_decoder.{i}'
        for flax_name, torch_name in _GPT2_DENSE:
            sd[f'{dst}.{torch_name}.weight'] = _t(src[flax_name]['kernel'])
            sd[f'{dst}.{torch_name}.bias'] = _t(src[flax_name]['bias'])
        for norm in ('ln_1', 'ln_2'):
            _layer_norm(sd, f'{dst}.{norm}', src[norm])
    return sd


def flax_txl_to_torch(params: Dict[str, Any], n_layer: int
                      ) -> Dict[str, torch.Tensor]:
    """Like :func:`flax_performer_to_torch`, for the stage-1
    ``PlainTransformer`` (the inverse of ``convert_stage1_pt``,
    ``train/convert_pt.py:45-69``): the shared r_w / r_r biases go to
    ``decoder.r_w_bias`` / ``decoder.r_r_bias``, each layer's attention to
    ``decoder.layers.{i}.dec_attn`` and its feed-forward to
    ``decoder.layers.{i}.pos_ff`` (``CoreNet.0`` / ``CoreNet.3``)."""
    p = params['params']
    sd = {'word_emb.emb_lookup.weight': _t(p['word_emb']['embedding']),
          'decoder.r_w_bias': _t(p['r_w_bias']),
          'decoder.r_r_bias': _t(p['r_r_bias']),
          'dec_out_proj.weight': _t(p['out_proj']['kernel']).T.contiguous(),
          'dec_out_proj.bias': _t(p['out_proj']['bias'])}
    if 'proj' in p['word_emb']:
        sd['word_emb.proj.weight'] = _t(
            p['word_emb']['proj']['kernel']).T.contiguous()
    for i in range(n_layer):
        src = p[f'layer_{i}']
        dst = f'decoder.layers.{i}'
        for name in ('qkv_net', 'r_net', 'o_net'):
            sd[f'{dst}.dec_attn.{name}.weight'] = _t(
                src['attn'][name]['kernel']).T.contiguous()
        _layer_norm(sd, f'{dst}.dec_attn.layer_norm', src['attn']['layer_norm'])
        for flax_name, idx in (('fc1', 0), ('fc2', 3)):
            dense = src['ff'][flax_name]
            sd[f'{dst}.pos_ff.CoreNet.{idx}.weight'] = _t(
                dense['kernel']).T.contiguous()
            sd[f'{dst}.pos_ff.CoreNet.{idx}.bias'] = _t(dense['bias'])
        _layer_norm(sd, f'{dst}.pos_ff.layer_norm', src['ff']['layer_norm'])
    return sd
