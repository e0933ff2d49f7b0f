"""Tensor-parallel parameter sharding (port of
``emo_disentanger_tpu/parallel/sharding_rules.py``).

The rules shard the widest matrices over the mesh's ``tp`` dim: expanding
projections by output column ('col'), their contracting counterparts by
input row ('row'), and the vocabulary projection by output column.  They
are keyed on the port's module names, which are the reference
checkpoints' (a suffix match on the module path):

* Performer: ``attention.{query,key,value}_projection`` col,
  ``attention.out_projection`` row, ``linear1`` col, ``linear2`` row;
* GPT-2: ``attn.c_attn`` col, ``attn.c_proj`` row, ``mlp.c_fc`` col,
  ``mlp.c_proj`` row;
* Transformer-XL: ``qkv_net`` and ``r_net`` col, ``o_net`` row,
  ``CoreNet.0`` col, ``CoreNet.3`` row;
* every family: ``dec_out_proj`` col.

An output projection is row-parallel inside a layer and column-parallel at
the top (the vocabulary head), the scope rule JAX applies to its shared
name ``out_proj``.  A dimension that ``tp`` does not divide stays
replicated, after JAX's check.

JAX places the kernels and lets XLA insert the collectives.  Here each rank
computes its heads locally, so :func:`shard_params` replaces each targeted
weight (and a column-parallel bias) by this rank's shard, and
:func:`parallel_linear` supplies the collectives Megatron-style, with the
loss computed whole on every tp rank:

* a column-parallel input passes through :func:`copy_to_tp` (identity
  forward, gradient all-reduced over tp on the way back);
* a row-parallel output is all-reduced (:func:`reduce_from_tp`, identity
  backward), and its bias is added once, after the reduction;
* the column-parallel vocabulary head gathers its logits
  (:func:`gather_from_tp`; its backward keeps this rank's columns).

A fused projection is split block by block: GPT-2's ``c_attn`` [D, 3D]
and the Transformer-XL's ``qkv_net`` hold q, k and v side by side, so a
rank takes its heads of each (a plain column split would hand rank 0 all
of q and half of k).  The Transformer-XL's ``r_net`` projects the position
embedding, not the hidden state, and is split the same way; its shared
biases r_w / r_r [H, Dh] match no rule and stay replicated, as in JAX, and
the forward takes this rank's heads of them through :func:`tp_heads`,
whose backward sums the gradient over tp (so every tp rank holds the
whole, equal gradient, and the clip counts it once).  The collectives run
in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from .mesh import mesh_shape, tp_group, tp_rank

# (module-path suffix, role); first match wins
DEFAULT_RULES = [
    (('attention', 'query_projection'), 'col'),
    (('attention', 'key_projection'), 'col'),
    (('attention', 'value_projection'), 'col'),
    (('linear1',), 'col'),
    (('linear2',), 'row'),
    (('attn', 'c_attn'), 'col'),
    (('attn', 'c_proj'), 'row'),
    (('mlp', 'c_fc'), 'col'),
    (('mlp', 'c_proj'), 'row'),
    (('qkv_net',), 'col'),
    (('r_net',), 'col'),
    (('o_net',), 'row'),
    (('CoreNet', '0'), 'col'),
    (('CoreNet', '3'), 'row'),
]
# the output projections, whose role depends on the scope
OUT_PROJ = ('out_projection', 'out_proj', 'dec_out_proj')
# fused projections: blocks side by side along the output dim
FUSED = {'c_attn': 3, 'qkv_net': 3}
# the contracting partner of each expanding in-layer projection, by name
# relative to the parent module
PARTNER = {'query_projection': 'out_projection',
           'key_projection': 'out_projection',
           'value_projection': 'out_projection', 'linear1': 'linear2',
           'c_attn': 'c_proj', 'c_fc': 'c_proj', 'qkv_net': 'o_net',
           'r_net': 'o_net'}
HEAD_SPLIT = ('query_projection', 'key_projection', 'value_projection',
              'c_attn', 'qkv_net', 'r_net')


def _role(path: str) -> Optional[str]:
    """'col', 'row' or None for the module at ``path``."""
    parts = tuple(path.split('.'))
    if parts[-1] in OUT_PROJ:
        in_layer = any(p.isdigit() for p in parts[:-1])
        return 'row' if in_layer else 'col'
    for suffix, role in DEFAULT_RULES:
        if parts[-len(suffix):] == suffix:
            return role
    return None


def _out_dim(mod: nn.Module) -> int:
    """The output dim of a weight: 0 for ``nn.Linear`` [out, in], 1 for
    GPT-2's ``Conv1D`` [in, out]."""
    return 0 if isinstance(mod, nn.Linear) else 1


def _targets(model: nn.Module, tp: int) -> Dict[str, str]:
    """{module path: role} of the modules the rules shard at this ``tp``,
    after the divisibility check on the sharded dim."""
    out = {}
    for path, mod in model.named_modules():
        w = getattr(mod, 'weight', None)
        if not isinstance(w, torch.Tensor) or w.dim() != 2:
            continue
        role = _role(path)
        if role is None or tp <= 1:
            continue
        dim = _out_dim(mod) if role == 'col' else 1 - _out_dim(mod)
        if w.shape[dim] % tp == 0:
            out[path] = role
    return out


def placement_report(model: nn.Module, mesh) -> Dict[str, str]:
    """Every parameter name -> 'col', 'row' or 'replicated' at the mesh's
    tp (``mesh`` may be a shape dict).  A column-parallel bias is 'col' (the
    port shards it with its weight); a row-parallel bias is 'replicated'
    (it is added once, after the reduction)."""
    targets = _targets(model, mesh_shape(mesh).get('tp', 1))
    report = {}
    for name, _ in model.named_parameters():
        path, _, leaf = name.rpartition('.')
        role = targets.get(path)
        if role is None or (leaf == 'bias' and role == 'row'):
            role = 'replicated'
        report[name] = role
    return report


def _shard(t: torch.Tensor, dim: int, tp: int, r: int, blocks: int = 1
           ) -> torch.Tensor:
    """Rank ``r``'s 1/tp of each of ``blocks`` equal blocks along ``dim``."""
    return torch.cat([b.chunk(tp, dim)[r] for b in t.chunk(blocks, dim)],
                     dim).contiguous()


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Replace each targeted weight (and a column-parallel bias) of
    ``model`` by this rank's shard, in place, and mark its module for
    :func:`parallel_linear`.  Call it before the optimizer is built (the
    parameters are new objects).  Sharded parameters carry
    ``tp_sharded = True`` (the optimizer's global norm sums them over tp).
    Raises where the shards could not be computed locally: attention heads
    that tp does not divide, or an expanding projection whose contracting
    partner stays replicated."""
    tp = mesh_shape(mesh).get('tp', 1)
    if tp <= 1:
        return model
    targets = _targets(model, tp)
    for path, role in targets.items():
        parent, _, leaf = path.rpartition('.')
        partner = PARTNER.get(leaf)
        if partner is not None and f'{parent}.{partner}' not in targets:
            raise ValueError(f'{path} is sharded over tp={tp} but '
                             f'{parent}.{partner} is not')
        if leaf in HEAD_SPLIT and model.n_head % tp:
            raise ValueError(f'n_head={model.n_head} does not split over '
                             f'tp={tp}')
    group, r = tp_group(mesh), tp_rank(mesh)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for path, role in targets.items():
            mod = modules[path]
            leaf = path.rpartition('.')[2]
            blocks = FUSED.get(leaf, 1)
            out = _out_dim(mod)
            dim = out if role == 'col' else 1 - out
            mod.weight = nn.Parameter(_shard(mod.weight, dim, tp, r, blocks))
            mod.weight.tp_sharded = True
            if role == 'col' and getattr(mod, 'bias', None) is not None:
                mod.bias = nn.Parameter(_shard(mod.bias, 0, tp, r, blocks))
                mod.bias.tp_sharded = True
            mod.tp_role = role
            mod.tp_gather = role == 'col' and leaf in OUT_PROJ
            mod.tp_group, mod.tp_size, mod.tp_rank = group, tp, r
    model.tp_size = tp
    return model


# ------------------------------------------------------------ collectives

class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _HeadsOfTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        n = x.shape[0] // size
        ctx.rows = slice(rank * n, (rank + 1) * n)
        ctx.shape, ctx.group = x.shape, group
        return x[ctx.rows].clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.rows] = g
        return _all_reduce(full, ctx.group), None, None, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        n = x.shape[-1]
        ctx.cols = slice(rank * n, (rank + 1) * n)
        full = x.new_zeros(x.shape[:-1] + (n * size,))
        full[..., ctx.cols] = x
        return _all_reduce(full, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.cols].contiguous(), None, None, None


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` in float32 (gloo's CUDA reduction takes every
    float type this way), returned in ``x``'s dtype."""
    y = x.to(torch.float32, memory_format=torch.contiguous_format,
             copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    return _GatherFromTP.apply(x, group, size, rank)


def tp_heads(x: torch.Tensor, mod: nn.Module) -> torch.Tensor:
    """This rank's heads (rows of dim 0, in tp order) of a replicated
    per-head tensor ``x`` [H, ...] when ``mod``, the projection that makes
    the heads, is column-sharded, else ``x``; the gradient is summed over
    tp on the way back."""
    if getattr(mod, 'tp_role', None) != 'col':
        return x
    return _HeadsOfTP.apply(x, mod.tp_group, mod.tp_size, mod.tp_rank)


def tp_input(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x`` as a column-parallel module's input: through
    :func:`copy_to_tp` when ``mod`` is column-sharded, else itself.  A layer
    whose q, k and v projections share one input copies it once and passes
    ``copied=True`` to :func:`parallel_linear`."""
    if getattr(mod, 'tp_role', None) == 'col':
        return copy_to_tp(x, mod.tp_group)
    return x


def parallel_linear(mod: nn.Module, x: torch.Tensor,
                    apply: Callable[[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]], torch.Tensor],
                    copied: bool = False) -> torch.Tensor:
    """``apply(x, weight, bias)`` for ``mod`` with its tensor-parallel
    collectives (module docstring); exactly ``apply(x, mod.weight,
    mod.bias)`` for a module that was never sharded."""
    role = getattr(mod, 'tp_role', None)
    if role is None:
        return apply(x, mod.weight, mod.bias)
    if role == 'row':
        y = reduce_from_tp(apply(x, mod.weight, None), mod.tp_group)
        return y if mod.bias is None else y + mod.bias.to(y.dtype)
    y = apply(x if copied else copy_to_tp(x, mod.tp_group), mod.weight,
              mod.bias)
    if mod.tp_gather:
        y = gather_from_tp(y, mod.tp_group, mod.tp_size, mod.tp_rank)
    return y
