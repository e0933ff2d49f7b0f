"""Vocabulary rule tables for the generation loop.

Port of ``emo_disentanger_tpu/infer/rules.py``: the reference's string-space
generation rules (``inference_utils.py:80-130``) as lookup tables indexed by
token id, so the batched loop can apply them to whole device tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.vocab import MAJOR_KEY, Vocab

POSITIVE_EMOTIONS = ('Positive', 'Q1', 'Q4')
NEGATIVE_EMOTIONS = ('Negative', 'Q2', 'Q3')


@dataclass
class RuleTables:
    is_beat: np.ndarray       # bool [V]
    beat_pos: np.ndarray      # int32 [V] (0 where not a Beat)
    is_bar: np.ndarray
    is_pad: np.ndarray
    is_eos: np.ndarray
    is_key: np.ndarray
    key_major: np.ndarray     # bool [V]: Key_<X> with X in MAJOR_KEY
    is_track_lead: np.ndarray
    is_track_full: np.ndarray


def build_rule_tables(vocab: Vocab) -> RuleTables:
    V = vocab.size
    t = RuleTables(*(np.zeros(V, dtype=bool) for _ in range(9)))
    t.beat_pos = np.zeros(V, dtype=np.int32)
    for idx, ev in vocab.idx2event.items():
        head = ev.split('_')[0]
        if head == 'Beat':
            t.is_beat[idx] = True
            t.beat_pos[idx] = int(ev.split('_')[-1])
        elif ev == 'Bar_None':
            t.is_bar[idx] = True
        elif ev == 'PAD_None':
            t.is_pad[idx] = True
        elif ev == 'EOS_None':
            t.is_eos[idx] = True
        elif head == 'Key':
            t.is_key[idx] = True
            t.key_major[idx] = ev.split('_')[1] in MAJOR_KEY
        elif ev == 'Track_LeadSheet':
            t.is_track_lead[idx] = True
        elif ev == 'Track_Full':
            t.is_track_full[idx] = True
    return t


def emotion_wants_major(emotion: str) -> bool:
    """Valence -> key-mode rule (reference ``match_emotion_key``,
    ``inference_utils.py:138-143``)."""
    if emotion in POSITIVE_EMOTIONS:
        return True
    if emotion in NEGATIVE_EMOTIONS:
        return False
    raise ValueError(f'unknown emotion {emotion!r}')
