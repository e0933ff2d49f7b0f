"""Checkpoints in the reference's file form (port of
``emo_disentanger_tpu/train/checkpoint.py``).

The reference saves ``ep{N:03d}_loss{L:.3f}_params.pt`` and ``_optim.pt``
per interval (``stage1_compose/train.py:317-323``); so does the port, with
``torch.save`` of the model's state dict and of :class:`Optimizer`'s.  The
JAX package's ``CKPT_RE`` matches these names.  A params file of the
reference model loads by name, without its ``feature_map.omega`` entries
(``train/convert_pt.py:9,28``): omega is a random-feature input, never a
parameter.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import List, Optional

import torch
from torch import nn

CKPT_RE = re.compile(r'ep(\d+)_loss([\d.]+?)(?:_params(?:\.pt)?)?$')
PARAMS, OPTIM = '_params.pt', '_optim.pt'


def checkpoint_name(epoch: int, loss: float) -> str:
    return 'ep{:03d}_loss{:.3f}'.format(epoch, loss)


def _save(obj, path: str) -> None:
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(obj, tmp)
    os.replace(tmp, path)            # a reader never sees half a file


def save_checkpoint(ckpt_dir: str, epoch: int, loss: float, model: nn.Module,
                    optimizer=None) -> str:
    """Write ``<ckpt_dir>/ep{N}_loss{L}_params.pt`` (and ``_optim.pt`` when
    ``optimizer`` is given); returns the params path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    stem = os.path.join(ckpt_dir, checkpoint_name(epoch, loss))
    _save(model.state_dict(), stem + PARAMS)
    if optimizer is not None:
        _save(optimizer.state_dict(), stem + OPTIM)
    return stem + PARAMS


def _params_path(path: str) -> str:
    return path if path.endswith('.pt') else path + PARAMS


def load_params(model: nn.Module, path: str) -> None:
    """Load a port or reference params file (or its ``ep..._loss...``
    stem) into ``model`` by name, dropping ``feature_map.omega`` keys."""
    state = torch.load(_params_path(path), map_location='cpu',
                       weights_only=True)
    model.load_state_dict({k: v for k, v in state.items()
                           if 'feature_map.omega' not in k})


def load_optimizer(optimizer, path: str) -> bool:
    """Load an ``_optim.pt`` the port wrote; returns False, with a warning,
    for any other file (a reference torch optimizer's state is laid out for
    the reference's parameter order), leaving Adam fresh."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    if not (isinstance(state, dict) and 'adam' in state):
        warnings.warn(f'optimizer state {path} is not the port\'s; '
                      'starting Adam fresh', RuntimeWarning)
        return False
    optimizer.load_state_dict(state)
    return True


def load_checkpoint(path: str, model: nn.Module, optimizer=None) -> bool:
    """Restore a checkpoint written by :func:`save_checkpoint` (``path`` is
    its params file or stem); returns whether the optimizer was restored."""
    params = _params_path(path)
    load_params(model, params)
    optim = params[:-len(PARAMS)] + OPTIM if params.endswith(PARAMS) else None
    if optimizer is None or optim is None or not os.path.exists(optim):
        return False
    return load_optimizer(optimizer, optim)


def _entries(ckpt_dir: str):
    out = []
    for name in os.listdir(ckpt_dir):
        m = CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), float(m.group(2).rstrip('.')), name))
    return sorted(out)


def gc_checkpoints(ckpt_dir: str, keep_last: int,
                   keep_best: bool = True) -> List[str]:
    """Keep-last-k retention: delete all but the ``keep_last`` most recent
    checkpoints (by epoch) and, with ``keep_best``, the lowest-loss one.
    A checkpoint's ``_optim.pt`` goes with its params file.  Returns the
    deleted paths."""
    if keep_last <= 0 or not os.path.isdir(ckpt_dir):
        return []
    entries = _entries(ckpt_dir)
    protect = {name for _, _, name in entries[-keep_last:]}
    if keep_best and entries:
        protect.add(min(entries, key=lambda e: e[1])[2])
    deleted = []
    for _, _, name in entries:
        if name in protect:
            continue
        path = os.path.join(ckpt_dir, name)
        for p in (path, path[:-len(PARAMS)] + OPTIM if path.endswith(PARAMS)
                  else None):
            if p is not None and os.path.exists(p):
                os.remove(p)
                deleted.append(p)
    return deleted


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The params file of the highest epoch in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    entries = _entries(ckpt_dir)
    return os.path.join(ckpt_dir, entries[-1][2]) if entries else None
