from .vocab import (
    Vocab, build_dictionary_from_dir, build_full_vocab, event_str,
    events_to_dictionary,
)
