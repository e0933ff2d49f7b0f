"""Weight bridge: flax ``MusicPerformer`` parameters -> this port's state dict.

The inverse of ``convert_performer_pt`` in the JAX package
(``train/convert_pt.py:31-42,72-93``): a flax Dense ``kernel`` [in, out]
becomes a torch ``weight`` [out, in], and a ``LayerNorm_0`` ``scale`` /
``bias`` pair becomes ``weight`` / ``bias``, under the reference
checkpoint's names.

A JAX gradient tree has the parameter tree's structure, so the same
function maps ``jax.grad`` of a flax loss onto the port's parameter names
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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def flax_performer_to_torch(params: Dict[str, Any], n_layer: int
                            ) -> Dict[str, torch.Tensor]:
    """``params`` is the ``{'params': {...}}`` tree flax's ``init`` returns
    (or a gradient tree of the same structure), as nested dicts of numpy
    arrays; returns a float32 CPU state dict for
    ``MusicPerformer.load_state_dict`` (cast afterwards for bf16 serving)."""
    p = params['params']
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
    for i in range(n_layer):
        src = p[f'layer_{i}']
        dst = f'transformer_decoder.decoder_layers.{i}'
        for flax_name, torch_name in _PROJ:
            sd[f'{dst}.{torch_name}.weight'] = _t(
                src[flax_name]['kernel']).T.contiguous()
            sd[f'{dst}.{torch_name}.bias'] = _t(src[flax_name]['bias'])
        for norm in ('norm1', 'norm2'):
            ln = src[norm]['LayerNorm_0']
            sd[f'{dst}.{norm}.weight'] = _t(ln['scale'])
            sd[f'{dst}.{norm}.bias'] = _t(ln['bias'])
    return sd
