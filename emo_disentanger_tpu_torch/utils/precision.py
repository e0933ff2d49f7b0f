"""Parameter precision casting for serving.

Weights stream from device memory every decode step; storing them in
bfloat16 halves that traffic.  Only parameters are cast: buffers (the
positional-encoding table) and the FAVOR+ omegas, which are explicit inputs
and never parameters, stay float32.
"""

from __future__ import annotations

import torch
from torch import nn


def cast_params(model: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast every float32 parameter of ``model`` to ``dtype`` in place and
    return ``model``."""
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return model
