"""Music-theory core: key <-> scale-degree math for the functional
representation (copy of ``emo_disentanger_tpu/core/theory.py``).

Capability parity with the reference's key/degree module
(``convert_key.py:33-233`` in EMO-Disentanger), re-built as deterministic
pure functions:

* the reference resolves the two non-diatonic minor degrees (semitones 4 and
  11 above the tonic) and the two off-scale Roman names (``II#``, ``V#``)
  with ``random.choice`` **at import time** (``convert_key.py:54,61,67,72``),
  making module constants nondeterministic across processes.  Here the
  resolution is an explicit, documented default that can be overridden via
  :func:`make_minor_maps`.

All tables use pitch-class arithmetic: pitch class 0 = C, 9 = A.
Supported MIDI pitch range is the piano range 21..108 (A0..C8).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# key tables
# ---------------------------------------------------------------------------

MAJOR_KEY = np.array(['C', 'C#', 'D', 'D#', 'E', 'F', 'F#', 'G', 'G#', 'A', 'A#', 'B'])
MINOR_KEY = np.array(['c', 'c#', 'd', 'd#', 'e', 'f', 'f#', 'g', 'g#', 'a', 'a#', 'b'])

IDX_TO_KEY: Dict[int, str] = {
    0: 'C', 1: 'C#', 2: 'D', 3: 'D#', 4: 'E', 5: 'F',
    6: 'F#', 7: 'G', 8: 'G#', 9: 'A', 10: 'A#', 11: 'B',
}
KEY_TO_IDX: Dict[str, int] = {v: k for k, v in IDX_TO_KEY.items()}

# Chromatic scale-degree names, relative to the tonic, in semitones.
MAJOR_DEGREE_TO_ROMAN: Dict[int, str] = {
    0: 'I', 1: 'I#', 2: 'II', 3: 'II#', 4: 'III', 5: 'IV',
    6: 'IV#', 7: 'V', 8: 'V#', 9: 'VI', 10: 'VI#', 11: 'VII',
}
ROMAN_TO_MAJOR_DEGREE: Dict[str, int] = {v: k for k, v in MAJOR_DEGREE_TO_ROMAN.items()}


def make_minor_maps(
    semitone4: str = 'III',
    semitone11: str = 'VII',
    roman_ii_sharp: int = 3,
    roman_v_sharp: int = 8,
) -> Tuple[Dict[int, str], Dict[str, int]]:
    """Build the (natural-)minor degree maps with explicit resolutions.

    The minor scale has no diatonic name for semitones 4 (between bIII and
    IV) and 11 (the raised leading tone between bVII and I); conversely the
    Roman names ``II#`` and ``V#`` have no unique minor semitone.  The
    reference picks among {``III``, ``IV``}, {``VII``, ``I``}, {2, 3} and
    {7, 8} randomly at import (``convert_key.py:54,61,67,72``); the defaults
    here pin the first listed option for the name maps and the harmonically
    closer option for the inverse maps.
    """
    assert semitone4 in ('III', 'IV') and semitone11 in ('VII', 'I')
    assert roman_ii_sharp in (2, 3) and roman_v_sharp in (7, 8)
    minor_degree_to_roman = {
        0: 'I', 1: 'I#', 2: 'II', 3: 'III', 4: semitone4, 5: 'IV',
        6: 'IV#', 7: 'V', 8: 'VI', 9: 'VI#', 10: 'VII', 11: semitone11,
    }
    roman_to_minor_degree = {
        'I': 0, 'I#': 1, 'II': 2, 'II#': roman_ii_sharp, 'III': 3,
        'IV': 5, 'IV#': 6, 'V': 7, 'V#': roman_v_sharp,
        'VI': 8, 'VI#': 9, 'VII': 10,
    }
    return minor_degree_to_roman, roman_to_minor_degree


MINOR_DEGREE_TO_ROMAN, ROMAN_TO_MINOR_DEGREE = make_minor_maps()


# ---------------------------------------------------------------------------
# pitch <-> degree
# ---------------------------------------------------------------------------

def _tonic_of(key: str) -> Tuple[int, bool]:
    """Return (tonic pitch class, is_major) for a key name like 'C' or 'c#'."""
    if key in KEY_TO_IDX:                      # upper case: major
        return KEY_TO_IDX[key], True
    upper = key.upper()
    if key != upper and upper in KEY_TO_IDX:   # lower case: minor
        return KEY_TO_IDX[upper], False
    raise NameError('Wrong key name {}.'.format(key))


def pitch2degree(
    key: str,
    pitch: int,
    minor_map: Optional[Mapping[int, str]] = None,
) -> Tuple[int, str]:
    """MIDI pitch -> (octave, Roman scale degree) in the given key.

    Matches the reference's convention (``convert_key.py:118-136``): the
    octave is ``(pitch - degree) // 12`` where ``degree`` is the semitone
    distance above the tonic, i.e. the octave of the *tonic* the pitch
    belongs to, not the pitch's own MIDI octave.
    """
    tonic, is_major = _tonic_of(key)
    degree = (pitch % 12 + 12 - tonic) % 12
    octave = (pitch - degree) // 12
    if is_major:
        roman = MAJOR_DEGREE_TO_ROMAN[degree]
    else:
        roman = (minor_map or MINOR_DEGREE_TO_ROMAN)[degree]
    return octave, roman


def degree2pitch(
    key: str,
    octave: int,
    roman: str,
    minor_map: Optional[Mapping[str, int]] = None,
) -> int:
    """(octave, Roman degree) -> MIDI pitch (inverse of :func:`pitch2degree`).

    Reference: ``convert_key.py:139-151``.
    """
    tonic, is_major = _tonic_of(key)
    if is_major:
        degree = ROMAN_TO_MAJOR_DEGREE[roman]
    else:
        degree = (minor_map or ROMAN_TO_MINOR_DEGREE)[roman]
    return octave * 12 + tonic + degree


# ---------------------------------------------------------------------------
# event-sequence rewrites (absolute <-> relative)
# ---------------------------------------------------------------------------

def _find_key(events: Iterable[dict], enforce_key_evs: Optional[dict]) -> str:
    if enforce_key_evs is not None:
        return enforce_key_evs['value']
    for ev in events:
        if ev['name'] == 'Key':
            return ev['value']
    raise ValueError('no Key event found and no enforced key given')


def absolute2relative(
    events: List[dict],
    enforce_key: bool = False,
    enforce_key_evs: Optional[dict] = None,
) -> List[dict]:
    """Rewrite ``Note_Pitch`` events to ``Note_Octave`` + ``Note_Degree``.

    Reference: ``convert_key.py:154-175``.
    """
    key = _find_key(events, enforce_key_evs if enforce_key else None)
    out: List[dict] = []
    for ev in events:
        if ev['name'] == 'Key':
            out.append({'name': 'Key', 'value': key})
        elif ev['name'] == 'Note_Pitch':
            octave, roman = pitch2degree(key, ev['value'])
            out.append({'name': 'Note_Octave', 'value': octave})
            out.append({'name': 'Note_Degree', 'value': roman})
        else:
            out.append(ev)
    return out


def relative2absolute(
    events: List[dict],
    enforce_key: bool = False,
    enforce_key_evs: Optional[dict] = None,
) -> List[dict]:
    """Rewrite ``Note_Octave``/``Note_Degree`` pairs back to ``Note_Pitch``,
    clamping to the piano range 21..108.

    Reference: ``convert_key.py:178-204``.
    """
    key = _find_key(events, enforce_key_evs if enforce_key else None)
    out: List[dict] = []
    octave = None
    for ev in events:
        if ev['name'] == 'Key':
            out.append({'name': 'Key', 'value': key})
        elif ev['name'] == 'Note_Octave':
            octave = ev['value']
        elif ev['name'] == 'Note_Degree':
            if octave is None:
                raise ValueError('Note_Degree without preceding Note_Octave')
            pitch = degree2pitch(key, octave, ev['value'])
            pitch = min(108, max(21, pitch))
            out.append({'name': 'Note_Pitch', 'value': pitch})
        else:
            out.append(ev)
    return out


# ---------------------------------------------------------------------------
# mode switching (valence-driven data augmentation)
# ---------------------------------------------------------------------------

def switch_key(key: str) -> Optional[str]:
    """Toggle a key (or ``Key_X`` token) between major and minor.

    Reference: ``convert_key.py:207-217``.
    """
    if '_' in key:
        keyname = key.split('_')[1]
        if keyname in MAJOR_KEY:
            return 'Key_' + keyname.lower()
        if keyname in MINOR_KEY:
            return 'Key_' + keyname.upper()
        return None
    if key in MAJOR_KEY:
        return key.lower()
    if key in MINOR_KEY:
        return key.upper()
    return None


def switch_melody(filename: str, events: List[dict], clip2keymode: Mapping[str, int]) -> List[dict]:
    """If a clip's key mode contradicts its valence quadrant, re-key the
    melody into the opposite mode (positive -> major, negative -> minor).

    Reference: ``convert_key.py:220-233``.
    """
    keymode = int(clip2keymode[filename])
    positive = filename[:2] in ('Q1', 'Q4')
    negative = filename[:2] in ('Q2', 'Q3')
    # already consistent: positive & minor / negative & major get switched,
    # so "no switch" is positive&minor==False... (kept identical to reference)
    if (positive and keymode == 1) or (negative and keymode == 0):
        return events
    keyname = 'C' if keymode == 0 else 'c'
    rel = absolute2relative(events, enforce_key=True,
                            enforce_key_evs={'name': 'Key', 'value': keyname})
    new_key = switch_key(keyname)
    return relative2absolute(rel, enforce_key=True,
                             enforce_key_evs={'name': 'Key', 'value': new_key})
