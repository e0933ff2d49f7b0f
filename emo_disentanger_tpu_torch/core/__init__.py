from .theory import (
    MAJOR_KEY,
    MINOR_KEY,
    IDX_TO_KEY,
    KEY_TO_IDX,
    MAJOR_DEGREE_TO_ROMAN,
    ROMAN_TO_MAJOR_DEGREE,
    MINOR_DEGREE_TO_ROMAN,
    ROMAN_TO_MINOR_DEGREE,
    pitch2degree,
    degree2pitch,
    absolute2relative,
    relative2absolute,
    switch_key,
    switch_melody,
)
from .quantize import (
    BEAT_RESOL,
    BAR_RESOL,
    TICK_RESOL,
    DEFAULT_TEMPO,
    DEFAULT_VELOCITY_BINS,
    DEFAULT_BPM_BINS,
    DEFAULT_SHIFT_BINS,
    DEFAULT_DURATION_BINS,
    nearest_bin,
)
from .events import Event, event_str
from .vocab import (
    Vocab, build_dictionary_from_dir, build_full_vocab, events_to_dictionary,
)
