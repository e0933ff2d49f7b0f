"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """Return ``device`` as a ``torch.device`` (a CUDA device with its index,
    so that it compares equal to a tensor's); raise when it names CUDA and
    no CUDA device is present.  Entry points default to ``'cuda'`` so that a
    run which silently lands on the CPU cannot be mistaken for a GPU run;
    callers that want the CPU (the tests) pass ``device='cpu'``."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev
