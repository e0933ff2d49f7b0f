from .datasets import Stage1Dataset, Stage1Sample, Stage2Dataset, Stage2Sample
from .emopia import (
    Corpus, analyze_midi, corpus_to_fullsong, corpus_to_leadsheet,
    corpus_to_stage2, quantize_to_corpus,
)
from .hooktheory import clip_is_usable, clip_to_leadsheet_events, load_hooktheory_json
from .midi_io import Instrument, Marker, MidiFile, Note, TempoChange, TimeSignature
from .pop1k7 import events_to_fullsong, events_to_stage2
from .splits import shuffle_split, split_emopia, split_hooktheory
