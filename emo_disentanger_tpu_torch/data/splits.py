"""Train/valid split builders (port of ``emo_disentanger_tpu/data/splits.py``;
reference ``representations/data_splits.py``).

EMOPIA: the provided train+val CSVs merge into the training set, the test CSV
becomes validation.  HookTheory: a 90/10 shuffled split with a fixed seed.
The reference calls ``sklearn.model_selection.train_test_split(
random_state=42)``; :func:`shuffle_split` is its semantics in numpy, without
sklearn: ``ceil(test_size * n)`` files go to validation, taken first from
``np.random.RandomState(seed).permutation(n)``.  (The JAX package's own
fallback rounds instead, and differs at n = 14, 25, 103, ...)
"""

from __future__ import annotations

import csv
import math
import os
import pickle
from typing import List, Sequence, Tuple

import numpy as np


def _read_clip_names(csv_path: str) -> List[str]:
    with open(csv_path, 'r') as f:
        rows = list(csv.reader(f))
    header, content = rows[0], rows[1:]
    col = header.index('clip_name')
    return [r[col] for r in content]


def _dump_split(output_dir: str, train_set: List[str], valid_set: List[str]) -> None:
    with open(os.path.join(output_dir, 'train.pkl'), 'wb') as f:
        pickle.dump(train_set, f)
    with open(os.path.join(output_dir, 'valid.pkl'), 'wb') as f:
        pickle.dump(valid_set, f)


def split_emopia(split_dir: str, output_dir: str) -> Tuple[List[str], List[str]]:
    os.makedirs(output_dir, exist_ok=True)
    train = _read_clip_names(os.path.join(split_dir, 'train_clip.csv'))
    valid = _read_clip_names(os.path.join(split_dir, 'val_clip.csv'))
    test = _read_clip_names(os.path.join(split_dir, 'test_clip.csv'))

    train_set = [c[:-4] + '.pkl' for c in train] + [c[:-4] + '.pkl' for c in valid]
    valid_set = [c[:-4] + '.pkl' for c in test]
    _dump_split(output_dir, train_set, valid_set)
    return train_set, valid_set


def shuffle_split(items: Sequence[str], test_size: float, seed: int
                  ) -> Tuple[List[str], List[str]]:
    """(train, valid) as ``sklearn``'s ``train_test_split(items,
    test_size=test_size, random_state=seed)`` returns them for a float
    ``test_size``, and its refusals: a size outside (0, 1) or an empty
    training set raises ValueError."""
    if not 0 < test_size < 1:
        raise ValueError(f'test_size={test_size} is not in (0, 1)')
    n = len(items)
    n_valid = math.ceil(test_size * n)
    if n - n_valid <= 0:
        raise ValueError(f'{n} items leave no training set at test_size={test_size}')
    order = np.random.RandomState(seed).permutation(n)
    return [items[i] for i in order[n_valid:]], [items[i] for i in order[:n_valid]]


def split_hooktheory(events_dir: str, output_dir: str,
                     test_size: float = 0.1, seed: int = 42) -> Tuple[List[str], List[str]]:
    os.makedirs(output_dir, exist_ok=True)
    train_set, valid_set = shuffle_split(os.listdir(events_dir), test_size, seed)
    _dump_split(output_dir, train_set, valid_set)
    return train_set, valid_set
