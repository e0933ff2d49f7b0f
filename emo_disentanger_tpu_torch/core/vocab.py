"""Vocabulary construction (copy of ``emo_disentanger_tpu/core/vocab.py``).

The dictionary is the sorted union of every event string observed in a
corpus and a synthetic full vocabulary covering all emotions, chords, notes,
durations, velocities and tempos.  ``Vocab`` adds the trailing PAD token the
dataloaders append at runtime.  Its constants come from the port's own
``core/theory.py``, ``core/quantize.py`` and ``core/events.py``
(``MAJOR_KEY`` and ``MINOR_KEY`` stay importable from here).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import numpy as np

from .events import event_str
from .quantize import VOCAB_DURATION_VALUES
from .theory import KEY_TO_IDX, MAJOR_DEGREE_TO_ROMAN, MAJOR_KEY, MINOR_KEY  # noqa: F401

DEFAULT_SCALE = ['C', 'C#', 'D', 'D#', 'E', 'F', 'F#', 'G', 'G#', 'A', 'A#', 'B']
STANDARD_QUALITIES = ['M', 'm', 'o', '+', '7', 'M7', 'm7', 'o7', '/o7', 'sus2', 'sus4']

PAD_EVENT = 'PAD_None'
BAR_EVENT = 'Bar_None'
EOS_EVENT = 'EOS_None'


def build_full_vocab(add_velocity: bool = True, add_emotion: bool = True,
                     add_tempo: bool = True, num_emotion: int = 4,
                     relative: bool = False) -> List[str]:
    """Synthetic full vocabulary (reference: ``events2words.py:31-85``)."""
    vocab: List[str] = []

    if add_emotion:
        emotions = ['Positive', 'Negative', None] if num_emotion == 2 \
            else ['Q1', 'Q2', 'Q3', 'Q4', None]
        vocab.extend('Emotion_{}'.format(e) for e in emotions)

    # chords: 12 roots (numeric degree or Roman) x 11 qualities + None
    scale = [KEY_TO_IDX[s] for s in DEFAULT_SCALE]
    if relative:
        scale = [MAJOR_DEGREE_TO_ROMAN[s] for s in scale]
    for s in scale:
        for q in STANDARD_QUALITIES:
            vocab.append('Chord_{}_{}'.format(s, q))
    vocab.append('Chord_None_None')

    # notes
    if relative:
        for o in range(21 // 12, 109 // 12 + 1):       # octaves 1..9
            vocab.append('Note_Octave_{}'.format(o))
        for d in MAJOR_DEGREE_TO_ROMAN.values():
            vocab.append('Note_Degree_{}'.format(d))
    else:
        for p in range(21, 109):
            vocab.append('Note_Pitch_{}'.format(p))
    if add_velocity:
        for v in np.linspace(4, 127, 42, dtype=int):
            vocab.append('Note_Velocity_{}'.format(int(v)))
    for d in VOCAB_DURATION_VALUES:
        vocab.append('Note_Duration_{}'.format(int(d)))

    if add_tempo:
        for t in np.linspace(32, 224, 64 + 1, dtype=int):
            vocab.append('Tempo_{}'.format(int(t)))

    return vocab


def events_to_dictionary(event_files_events: Iterable[List],
                         add_velocity: bool = False, add_emotion: bool = True,
                         add_tempo: bool = True, num_emotion: int = 4,
                         relative: bool = False) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Build (event2word, word2event) from corpora event lists + full vocab,
    indices assigned in sorted string order (``events2words.py:88-118``)."""
    all_events: List[str] = []
    for events in event_files_events:
        all_events.extend(event_str(e) for e in events)
    all_events.extend(build_full_vocab(
        add_velocity=add_velocity, add_emotion=add_emotion, add_tempo=add_tempo,
        num_emotion=num_emotion, relative=relative))
    unique_events = sorted(set(all_events))
    event2word = {key: i for i, key in enumerate(unique_events)}
    word2event = {i: key for i, key in enumerate(unique_events)}
    return event2word, word2event


def build_dictionary_from_dir(events_root: str, event_pos: int = 2, **kwargs) -> str:
    """Scan ``<root>/events/*.pkl`` (the project's own event pickles), write
    ``<root>/dictionary.pkl`` and return its path (``events2words.py:88-118``)."""
    event_dir = os.path.join(events_root, 'events')
    dictionary_path = os.path.join(events_root, 'dictionary.pkl')
    all_file_events = []
    for fname in sorted(os.listdir(event_dir)):
        with open(os.path.join(event_dir, fname), 'rb') as f:
            payload = pickle.load(f)
        all_file_events.append(payload[event_pos])
    event2word, word2event = events_to_dictionary(all_file_events, **kwargs)
    with open(dictionary_path, 'wb') as f:
        pickle.dump((event2word, word2event), f)
    return dictionary_path


@dataclass
class Vocab:
    """A dictionary plus the runtime PAD token appended by dataloaders."""
    event2idx: Dict[str, int]
    idx2event: Dict[int, str]
    pad_id: int = field(init=False)
    size: int = field(init=False)

    def __post_init__(self):
        orig = len(self.event2idx)
        self.pad_id = orig
        self.event2idx = dict(self.event2idx)
        self.idx2event = dict(self.idx2event)
        self.event2idx[PAD_EVENT] = self.pad_id
        self.idx2event[self.pad_id] = PAD_EVENT
        self.size = self.pad_id + 1

    @classmethod
    def load(cls, path: str) -> 'Vocab':
        """Read a ``dictionary.pkl`` written by :func:`build_dictionary_from_dir`."""
        with open(path, 'rb') as f:
            event2word, word2event = pickle.load(f)
        return cls(event2word, word2event)

    def encode(self, events: Iterable) -> List[int]:
        return [self.event2idx[event_str(e)] for e in events]

    def decode(self, ids: Iterable[int]) -> List[str]:
        return [self.idx2event[int(i)] for i in ids]

    @property
    def bar_id(self) -> int:
        return self.event2idx[BAR_EVENT]

    @property
    def eos_id(self) -> int:
        return self.event2idx[EOS_EVENT]
