"""CLI: dataset tokenization (port of ``emo_disentanger_tpu/cli/midi2events.py``;
reference ``representations/midi2events_*.py`` ``__main__`` blocks): EMOPIA
MIDI / HookTheory JSON / Pop1K7 pickles -> event pickles under
``events/...``, with ``-r/--representation`` and ``-e/--event_type``
preserved, plus ``-d/--dataset`` selecting the corpus.  Host work in numpy:

    python -m emo_disentanger_tpu_torch midi2events -d emopia -r functional \
        -e lead2full --data_home midi_data/EMOPIA+
"""

import argparse
import json
import os
import pickle


def _repr_flags(representation: str):
    if representation == 'remi':
        return False, False, False
    if representation == 'functional':
        return False, True, True
    raise ValueError(representation)


def run_emopia(representation: str, event_type: str, data_home: str,
               out_root: str = 'events') -> str:
    from ..data.midi_io import MidiFile
    from ..data.emopia import (
        analyze_midi, quantize_to_corpus, corpus_to_leadsheet,
        corpus_to_stage2, corpus_to_fullsong,
    )
    transpose_to_C, relative_chord, relative_melody = _repr_flags(representation)

    stage = {'lead': 'stage1', 'lead2full': 'stage2', 'full': 'stage1'}[event_type]
    layout = 'lead_sheet_chord11_{}' if event_type == 'lead' else 'full_song_chord11_{}'
    out_dir = os.path.join(out_root, stage, 'emopia_events',
                           layout.format(representation), 'events')
    os.makedirs(out_dir, exist_ok=True)

    midi_home = os.path.join(data_home, 'midis')
    with open(os.path.join(data_home, 'adjust_keyname.json')) as f:
        clip2keyname = json.load(f)

    for fname in sorted(os.listdir(midi_home)):
        if not fname.endswith('.mid'):
            continue
        name = fname[:-4]
        keyname = clip2keyname[name]
        emotion = name[:2]
        if event_type == 'lead':
            if emotion in ('Q1', 'Q4'):
                emotion = 'Positive'
            elif emotion in ('Q2', 'Q3'):
                emotion = 'Negative'

        # EMOPIA files are 480 PPQN; real-world inputs at other divisions
        # are rescaled onto the tokenizer grid first
        midi = MidiFile.parse(os.path.join(midi_home, fname)).to_resolution(480)
        if event_type == 'lead':
            corpus = quantize_to_corpus(analyze_midi(
                midi, keyname, melody_only=True, relative_chord=relative_chord,
                transpose_to_C=transpose_to_C))
            payload = corpus_to_leadsheet(corpus, emotion,
                                          relative_melody=relative_melody,
                                          relative_chord=relative_chord)
        elif event_type == 'lead2full':
            lead = quantize_to_corpus(analyze_midi(
                midi, keyname, melody_only=True, tempo_conti=True,
                relative_chord=relative_chord, transpose_to_C=transpose_to_C))
            # analyze_midi copies what it changes, so one parse serves both
            full = quantize_to_corpus(analyze_midi(
                midi, keyname,
                melody_only=False, chord_conti=True, tempo_conti=True,
                relative_chord=relative_chord, transpose_to_C=transpose_to_C))
            payload = corpus_to_stage2(lead, full, emotion,
                                       relative_melody=relative_melody,
                                       relative_chord=relative_chord)
        else:  # full
            corpus = quantize_to_corpus(analyze_midi(
                midi, keyname, melody_only=False,
                relative_chord=relative_chord, transpose_to_C=transpose_to_C))
            payload = corpus_to_fullsong(corpus, emotion,
                                         relative_melody=relative_melody,
                                         relative_chord=relative_chord)
        with open(os.path.join(out_dir, name + '.pkl'), 'wb') as f:
            pickle.dump(payload, f)
    return out_dir


def run_hooktheory(representation: str, data_home: str,
                   out_root: str = 'events') -> str:
    from ..data.hooktheory import (
        load_hooktheory_json, clip_is_usable, clip_to_leadsheet_events,
    )
    transpose_to_C, relative_chord, relative_melody = _repr_flags(representation)

    out_dir = os.path.join(out_root, 'stage1', 'hooktheory_events',
                           'lead_sheet_chord11_{}'.format(representation),
                           'events')
    os.makedirs(out_dir, exist_ok=True)

    dataset = load_hooktheory_json(os.path.join(data_home, 'Hooktheory.json.gz'))
    n = 0
    for name, clip in dataset.items():
        if not clip_is_usable(clip):
            continue
        payload = clip_to_leadsheet_events(
            clip, relative_chord=relative_chord,
            relative_melody=relative_melody, transpose_to_C=transpose_to_C)
        if payload is None:
            continue
        with open(os.path.join(out_dir, name + '.pkl'), 'wb') as f:
            pickle.dump(payload, f)
        n += 1
    print('# samples:', n)
    return out_dir


def run_pop1k7(representation: str, event_type: str, data_home: str,
               out_root: str = 'events') -> str:
    from ..data.pop1k7 import events_to_stage2, events_to_fullsong
    transpose_to_C, relative_chord, relative_melody = _repr_flags(representation)

    stage = 'stage2' if event_type == 'lead2full' else 'stage1'
    out_dir = os.path.join(out_root, stage, 'pop1k7_events',
                           'full_song_chorder_{}'.format(representation),
                           'events')
    os.makedirs(out_dir, exist_ok=True)

    old_dir = os.path.join(data_home, 'pop1k7_leedsheet2midi')
    with open(os.path.join(data_home, 'pop1k7_keyname.json')) as f:
        midi2key = json.load(f)

    for sample in sorted(os.listdir(old_dir)):
        keyname = midi2key[sample[:-4]]
        with open(os.path.join(old_dir, sample), 'rb') as f:
            skyline_pos, midi_pos, events = pickle.load(f)
        if event_type == 'lead2full':
            payload = events_to_stage2(events, keyname,
                                       relative_chord=relative_chord,
                                       relative_melody=relative_melody)
        else:
            payload = events_to_fullsong(skyline_pos, midi_pos, events, keyname,
                                         relative_chord=relative_chord,
                                         relative_melody=relative_melody)
        with open(os.path.join(out_dir, sample), 'wb') as f:
            pickle.dump(payload, f)
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser(description='MIDI/JSON -> event pickles')
    required = parser.add_argument_group('required arguments')
    required.add_argument('-d', '--dataset', required=True,
                          choices=['emopia', 'hooktheory', 'pop1k7'])
    required.add_argument('-r', '--representation', required=True,
                          choices=['remi', 'functional'])
    parser.add_argument('-e', '--event_type', default='lead',
                        choices=['lead', 'lead2full', 'full'])
    parser.add_argument('--data_home', default=None)
    parser.add_argument('--out_root', default='events')
    args = parser.parse_args(argv)

    if args.dataset == 'emopia':
        out = run_emopia(args.representation, args.event_type,
                         args.data_home or 'midi_data/EMOPIA+', args.out_root)
    elif args.dataset == 'hooktheory':
        out = run_hooktheory(args.representation,
                             args.data_home or 'midi_data/HookTheory',
                             args.out_root)
    else:
        out = run_pop1k7(args.representation, args.event_type,
                         args.data_home or 'midi_data/Pop1K7-emo', args.out_root)
    print('events written to', out)


if __name__ == '__main__':
    main()
