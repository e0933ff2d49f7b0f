"""Pop1K7 (Compose&Embellish pickles) -> the event layouts (stage-2 /
one-stage pretraining corpora; port of ``emo_disentanger_tpu/data/pop1k7.py``).

Parity with the reference (``midi2events_pop1k7.py``): re-tokenizes
``(skyline_pos, midi_pos, events)`` pickles into the functional/REMI layouts,
guaranteeing a Chord event at beats 0/4/8/12 of every lead-sheet bar
(stage 2) or a Tempo+Chord pair at every quarter beat (one-stage), with the
reference's consistency invariants checked (a ValueError where JAX asserts).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from ..core.theory import (
    MAJOR_KEY, IDX_TO_KEY, MAJOR_DEGREE_TO_ROMAN, MINOR_DEGREE_TO_ROMAN,
    pitch2degree,
)
from ..core.events import Event


def _root2degree_map(keyname: str, relative_chord: bool) -> Dict[str, str]:
    if relative_chord:
        start = int(np.where(MAJOR_KEY == keyname.upper())[0][0])
        rotated = np.concatenate([MAJOR_KEY[start:], MAJOR_KEY[:start]])
        return {rotated[i]: str(i) for i in range(12)}
    return {MAJOR_KEY[i]: str(i) for i in range(12)}


def _translate_chord(value: str, keyname: str, root2degree: Dict[str, str],
                     relative_melody: bool) -> str:
    """'<pc>_<quality>' with numeric pitch-class root -> degree/Roman root."""
    root, quality = value.split('_')
    root = root2degree[IDX_TO_KEY[int(root)]]
    if relative_melody and root != 'None':
        table = MAJOR_DEGREE_TO_ROMAN if keyname in MAJOR_KEY else MINOR_DEGREE_TO_ROMAN
        root = table[int(root)]
    return root + '_' + quality


def events_to_stage2(events: List[dict], keyname: str, *,
                     relative_chord: bool, relative_melody: bool,
                     ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]], List[dict]]:
    """Compose&Embellish interleaved events -> stage-2 layout with per-quarter
    chord guarantees (reference ``event2lead_full``,
    ``midi2events_pop1k7.py:19-125``)."""
    out: List[dict] = [Event('Emotion', None)]
    if relative_chord:
        out.append(Event('Key', keyname))

    root2degree = _root2degree_map(keyname, relative_chord)

    ls_start: List[int] = []
    full_start: List[int] = []
    for ev in events:
        if ev['name'] == 'Chord' and ev['value'] not in ('Conti_Conti', 'None_None'):
            out.append(Event('Chord', _translate_chord(
                ev['value'], keyname, root2degree, relative_melody)))
        elif ev['name'] == 'Note_Pitch':
            if relative_melody:
                octave, roman = pitch2degree(keyname, ev['value'])
                out.append(Event('Note_Octave', octave))
                out.append(Event('Note_Degree', roman))
            else:
                out.append(ev)
        elif ev['name'] == 'Track':
            if ev['value'] == 'Skyline':
                ls_start.append(len(out))
                out.append(Event('Track', 'LeadSheet'))
            elif ev['value'] == 'Midi':
                full_start.append(len(out))
                out.append(Event('Track', 'Full'))
        else:
            out.append(ev)
    ls_start.append(len(out))
    if len(ls_start) != len(full_start) + 1:
        raise ValueError('Skyline and Midi tracks do not alternate')

    # ensure a Chord at beats 0/4/8/12 of every lead-sheet bar
    final: List[dict] = out[:ls_start[0]]
    ls_new: List[int] = []
    full_new: List[int] = []
    chord = 'None_None'
    for s in range(len(full_start)):
        ls_new.append(len(final))
        lead_evs = out[ls_start[s]:full_start[s]]
        full_evs = out[full_start[s]:ls_start[s + 1]]

        rebuilt = lead_evs[:2]              # Track_LeadSheet, Bar
        beat_seq: Dict[int, List[dict]] = {}
        beat = None
        if len(lead_evs) > 3:
            for ev in lead_evs[2:]:
                if ev['name'] == 'Beat':
                    beat = ev['value']
                    beat_seq[beat] = []
                else:
                    if beat not in beat_seq:
                        break
                    beat_seq[beat].append(ev)
        for b in (0, 4, 8, 12):
            if b not in beat_seq:
                beat_seq[b] = [Event('Chord', chord)]
            elif beat_seq[b] and beat_seq[b][0]['name'] == 'Chord':
                chord = beat_seq[b][0]['value']
            else:
                beat_seq[b] = [Event('Chord', chord)] + beat_seq[b]
        for b in range(16):
            if b in beat_seq:
                rebuilt.append(Event('Beat', b))
                rebuilt.extend(beat_seq[b])

        final += rebuilt
        full_new.append(len(final))
        final += full_evs
    ls_new.append(len(final))

    lead_pos = [(ls_new[j], full_new[j]) for j in range(len(full_new))]
    full_pos = [(full_new[j], ls_new[j + 1]) for j in range(len(full_new))]
    return lead_pos, full_pos, final


def events_to_fullsong(skyline_pos, midi_pos, events: List[dict], keyname: str, *,
                       relative_chord: bool, relative_melody: bool,
                       ) -> Tuple[List[int], List[dict]]:
    """Compose&Embellish events -> one-stage layout with Tempo+Chord at every
    quarter beat (reference ``event2full``, ``midi2events_pop1k7.py:128-253``)."""
    out: List[dict] = [Event('Emotion', None)]
    if relative_chord:
        out.append(Event('Key', keyname))

    root2degree = _root2degree_map(keyname, relative_chord)

    if events[0]['name'] != 'Tempo':
        raise ValueError('a Pop1K7 song opens with its Tempo event')
    global_tempo = events[0]
    out.append(global_tempo)

    positions: List[int] = []
    for pos in midi_pos:
        midi_events = events[pos[0] + 1:pos[1]]
        positions.append(len(out))

        bar_events: List[dict] = []
        beat_seq: Dict[str, List[dict]] = defaultdict(list)
        beat_key = None
        for ev in midi_events:
            if ev['name'] == 'Bar':
                bar_events.append(ev)
            elif ev['name'] == 'Beat':
                beat_key = 'Beat_{}'.format(ev['value'])
                beat_seq[beat_key]  # touch to register the beat
            else:
                beat_seq[beat_key].append(ev)

        prev_tempo = global_tempo
        prev_chord = Event('Chord', 'None_None')
        for b in (0, 4, 8, 12):
            bk = 'Beat_{}'.format(b)
            if bk not in beat_seq:
                beat_seq[bk].append(prev_tempo)
                beat_seq[bk].append(prev_chord)
                continue
            evs = beat_seq[bk]
            # tempo first
            if evs and evs[0]['name'] == 'Tempo':
                if evs[0]['value'] == 'Conti':
                    evs[0] = Event('Tempo', prev_tempo['value'])
                prev_tempo = evs[0]
            else:
                evs = [prev_tempo] + evs
            # chord second
            if len(evs) == 1:
                evs = [evs[0], prev_chord]
            elif evs[1]['name'] != 'Chord':
                evs = [evs[0], prev_chord] + evs[1:]
            else:
                if evs[1]['value'] == 'Conti_Conti':
                    evs[1] = Event('Chord', prev_chord['value'])
                prev_chord = evs[1]
            beat_seq[bk] = evs

        for b in range(16):
            bk = 'Beat_{}'.format(b)
            if bk not in beat_seq:
                continue
            bar_events.append(Event('Beat', b))
            for ev in beat_seq[bk]:
                if ev['name'] == 'Tempo':
                    bar_events.append(ev)
                elif ev['name'] == 'Chord':
                    if ev['value'] == 'None_None':
                        bar_events.append(ev)
                    else:
                        bar_events.append(Event('Chord', _translate_chord(
                            ev['value'], keyname, root2degree, relative_melody)))
                elif ev['name'] == 'Note_Pitch':
                    if relative_melody:
                        octave, roman = pitch2degree(keyname, ev['value'])
                        bar_events.append(Event('Note_Octave', octave))
                        bar_events.append(Event('Note_Degree', roman))
                    else:
                        bar_events.append(ev)
                else:
                    bar_events.append(ev)

        out.extend(bar_events)

    out.append(Event('EOS', None))
    if len(skyline_pos) != len(positions):
        raise ValueError('Skyline and Midi bar counts differ')

    # consistency invariants (reference ``midi2events_pop1k7.py:242-251``)
    count: Dict[str, int] = defaultdict(int)
    for ev in out:
        if ev['name'] in ('Chord', 'Tempo'):
            count[ev['name']] += 1
        elif ev['name'] == 'Beat':
            count['Beat_{}'.format(ev['value'])] += 1
    if (count['Tempo'] != count['Chord'] + 1
            or count['Beat_0'] + count['Beat_4'] + count['Beat_8']
            + count['Beat_12'] != count['Chord']):
        raise ValueError('a quarter beat lacks its Tempo and Chord events')

    return positions, out
