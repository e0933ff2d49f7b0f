from .device import resolve_device
from .precision import cast_params
