"""Event primitives (copy of ``emo_disentanger_tpu/core/events.py``).

Events are the unit of all token streams: a ``{'name': ..., 'value': ...}``
pair serialized to the string ``"{name}_{value}"``.  On-disk artifacts keep
the dict form for compatibility with the reference's pickles
(``midi2events_emopia.py:367-371``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Union


def Event(name: str, value: Any) -> Dict[str, Any]:
    """Create an event dict (reference: ``create_event``)."""
    return {'name': name, 'value': value}


def event_str(event: Union[Dict[str, Any], str]) -> str:
    """Serialize an event to its vocabulary string form."""
    if isinstance(event, str):
        return event
    return '{}_{}'.format(event['name'], event['value'])


def events_to_strs(events: List[Union[Dict[str, Any], str]]) -> List[str]:
    return [event_str(e) for e in events]


def split_event_str(ev: str):
    """Split a vocabulary string back into (name, value).

    Mirrors the parse rules of the reference's ``ConversionEvent``
    (``convert2midi.py:88-98``): ``Note_*`` keep the multi-part name,
    ``Chord_*`` keep the multi-part value.
    """
    if ev.startswith('Note'):
        parts = ev.split('_')
        return '_'.join(parts[:-1]), parts[-1]
    if ev.startswith('Chord'):
        parts = ev.split('_')
        return parts[0], '_'.join(parts[1:])
    name, _, value = ev.partition('_')
    return name, value
