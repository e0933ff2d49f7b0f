"""Debug-mode numerical sanitizers (port of
``emo_disentanger_tpu/utils/debug.py``): NaN/Inf surfacing with the name of
the first offender instead of silently propagating through training.

Usage::

    step = checked_train_step(loss_fn, model, optimizer)  # not make_train_step
    err, (loss, aux) = step(batch, extras)
    err.throw()    # raises naming the first non-finite loss, gradient or
                   # updated parameter

Intended for debugging runs: the step runs its backward under
``torch.autograd.detect_anomaly`` and reads every gradient and parameter
back, so production training keeps the unchecked ``make_train_step``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch
from torch import nn


class CheckError:
    """The outcome of a checked step: ``get()`` is None or the message;
    ``throw()`` raises ``FloatingPointError`` with it."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def _first_non_finite(named) -> Optional[str]:
    for name, t in named:
        if t is not None and t.is_floating_point() and \
                not bool(torch.isfinite(t).all()):
            return name
    return None


def checked_train_step(loss_fn: Callable, model: nn.Module, optimizer):
    """A train step (``train.trainer.make_train_step``'s calling
    convention, ``step(batch, extras)``) that returns ``err, (loss, aux)``.
    It checks, in order, the loss, every gradient (the backward runs under
    anomaly detection, which names the autograd function that first made a
    NaN) and every updated parameter.  A non-finite loss or gradient leaves
    the parameters and the optimizer as they were, so the state that failed
    can be inspected; ``err.throw()`` raises either way."""
    def step(batch, extras):
        model.train()
        with torch.autograd.detect_anomaly(check_nan=True):
            loss, aux = loss_fn(batch, extras)
            message = None
            if not bool(torch.isfinite(loss)):
                message = f'non-finite loss: {float(loss)}'
            else:
                try:
                    loss.backward()
                except RuntimeError as e:
                    message = f'non-finite gradient: {e}'
        if message is None:
            bad = _first_non_finite((n, p.grad)
                                    for n, p in model.named_parameters())
            if bad is not None:
                message = f'non-finite gradient of {bad}'
        if message is not None:
            model.zero_grad(set_to_none=True)
            return CheckError(message), (loss.detach(), aux)
        optimizer.step()
        bad = _first_non_finite(model.named_parameters())
        if bad is not None:
            message = f'non-finite parameter {bad} after the update'
        return CheckError(message), (loss.detach(), aux)
    return step


def _leaves(tree: Any, path: str = ''):
    """(JAX ``keystr`` path, array) of every leaf of nested dicts, lists and
    tuples of tensors or arrays."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f'{path}[{k!r}]')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f'{path}[{i}]')
    else:
        yield path, tree


def assert_all_finite(tree: Any, name: str = 'tree') -> None:
    """Host-side sanity sweep over a state dict, a module's parameters or a
    nested container of tensors and arrays (checkpoints, converted
    parameters).  Raises ``ValueError`` with JAX's message."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    bad: List[str] = []
    for path, leaf in _leaves(tree):
        arr = (leaf.detach().float().cpu().numpy()
               if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
               else np.asarray(leaf))
        if arr.dtype.kind == 'f' and not np.isfinite(arr).all():
            bad.append(path)
    if bad:
        raise ValueError(f'non-finite values in {name}: {bad[:10]}')
