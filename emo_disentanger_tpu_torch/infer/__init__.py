from .reference_exact import (
    generate_stage1_reference_exact, generate_stage2_reference_exact)
from .rules import build_rule_tables, emotion_wants_major
from .stage1 import Stage1Generator
from .stage1_batch import Stage1BatchGenerator
from .stage2 import Stage2Generator
from .stage2_batch import Stage2BatchGenerator
from .convert2midi import (
    CHORD_MAPS, RenderMode, TempoEvent, add_chord_track, chord_to_pitches,
    events_to_midi)
from .pipeline import (
    roman_events_to_absolute, events_to_txt, read_generated_events,
    extract_midi_events_from_generation, merge_tracks,
    construct_inadmissible_set, emotion_candidates_for_file,
)
from .metrics import emotion_profile
from .audio import midi_to_wav
