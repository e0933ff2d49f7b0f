"""The stage-1 traffic: the lead-sheet vocabulary, the generation queue's
primers and song sizes, and the head grammar a random model is given, all
drawn from the run's seed.

The vocabulary is the reference's functional stage-1 one
(``events2words.py`` ``build_full_vocab`` with two emotions, no velocity,
no tempo, relative degrees) plus the lead-sheet corpus's specials, built
here so that the yardstick does not move with the program: 215 events, and
PAD makes 216 tokens.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .traffic import CHORD_ROOTS, DEGREES, MAJOR_KEY, MINOR_KEY, QUALITIES, song_bars

DURATIONS = tuple(range(120, 1920 + 120, 120))


def dictionary() -> Tuple[Dict[str, int], Dict[int, str]]:
    """(event2word, word2event): the events in sorted order, as
    ``events2words`` indexes them."""
    ev = [f'Emotion_{e}' for e in ('Positive', 'Negative', None)]
    ev += [f'Chord_{r}_{q}' for r in CHORD_ROOTS for q in QUALITIES]
    ev.append('Chord_None_None')
    ev += [f'Note_Octave_{o}' for o in range(1, 10)]
    ev += [f'Note_Degree_{d}' for d in CHORD_ROOTS]
    ev += [f'Note_Duration_{d}' for d in DURATIONS]
    ev += ['Bar_None', 'EOS_None'] + [f'Beat_{b}' for b in range(16)]
    ev += [f'Key_{k}' for k in MAJOR_KEY + MINOR_KEY]
    events = sorted(set(ev))
    return ({e: i for i, e in enumerate(events)},
            {i: e for i, e in enumerate(events)})


def jobs(n_jobs: int, lo: int, hi: int, rng: np.random.RandomState,
         same_sizes: bool = False) -> Tuple[List[str], List[List[str]], List[int]]:
    """(emotions, primers, target bars) of ``n_jobs`` songs: Positive with a
    major key and Negative with a minor key in turn, the key drawn from
    ``rng``; the primer holds the key, so the generator's sampled key step
    never comes.  The bars run lo .. hi as ``traffic.song_bars`` orders
    them."""
    emotions, primers = [], []
    for j in range(n_jobs):
        positive = j % 2 == 0
        keys = MAJOR_KEY if positive else MINOR_KEY
        emotion = 'Positive' if positive else 'Negative'
        emotions.append(emotion)
        primers.append([f'Emotion_{emotion}', f'Key_{keys[rng.randint(12)]}'])
    return emotions, primers, song_bars(n_jobs, lo, hi, rng, same_sizes)


# the next events each event allows: a head that follows it makes a random
# model write bars of six events (Bar_None, Beat_0, a chord, Octave 5, a
# degree, a duration) after the primer's key, so no draw is rejected (one
# beat a bar), no song ends before its bars (no EOS), and a song's length is
# set by its target bars alone; the model chooses the chord (the seven
# diatonic triads and sevenths), the degree (7) and the duration (16), near
# ties that the check reads
CHORDS = tuple(f'Chord_{c}' for c in ('I_M', 'II_m', 'III_m', 'IV_M', 'V_7',
                                       'VI_m', 'VII_o'))
LEAD_GRAMMAR = {
    **{f'Key_{k}': ['Bar_None'] for k in MAJOR_KEY + MINOR_KEY},
    'Bar_None': ['Beat_0'],
    'Beat_0': list(CHORDS),
    **{c: ['Note_Octave_5'] for c in CHORDS},
    'Note_Octave_5': [f'Note_Degree_{d}' for d in DEGREES],
    **{f'Note_Degree_{d}': [f'Note_Duration_{k}' for k in DURATIONS]
       for d in DEGREES},
    **{f'Note_Duration_{k}': ['Bar_None'] for k in DURATIONS},
}
EVENTS_PER_BAR = 6


def events_after_primer(bars: int) -> int:
    """The events a song of ``bars`` target bars writes after its primer
    under ``LEAD_GRAMMAR``: it stops at its last bar's Bar_None."""
    return EVENTS_PER_BAR * (bars - 1) + 1
