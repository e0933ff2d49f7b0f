"""Small IO helpers (port of ``emo_disentanger_tpu/utils/io.py``)."""

from __future__ import annotations

import pickle
from typing import Any


def pickle_load(path: str) -> Any:
    with open(path, 'rb') as f:
        return pickle.load(f)


def load_yaml(path: str) -> dict:
    """Read a YAML config.  PyYAML is imported here, not at module import,
    so the rest of the port runs where it is not installed."""
    import yaml
    with open(path, 'r') as f:
        return yaml.safe_load(f)
