"""CLI: vocabulary construction (copy of ``emo_disentanger_tpu/cli/events2words.py``;
reference ``representations/events2words.py`` ``__main__``): builds
``dictionary.pkl`` for the six corpus layouts."""

import argparse
import os

from ..core.vocab import build_dictionary_from_dir

CORPORA = [
    # (root template, kwargs) — reference events2words.py:140-171
    ('events/stage1/hooktheory_events/lead_sheet_chord11_{}',
     dict(add_velocity=False, add_emotion=True, add_tempo=False,
          num_emotion=2, event_pos=1)),
    ('events/stage1/emopia_events/lead_sheet_chord11_{}',
     dict(add_velocity=False, add_emotion=True, add_tempo=False,
          num_emotion=2, event_pos=1)),
    ('events/stage2/pop1k7_events/full_song_chorder_{}',
     dict(add_velocity=True, add_emotion=True, add_tempo=True,
          num_emotion=4, event_pos=2)),
    ('events/stage2/emopia_events/full_song_chord11_{}',
     dict(add_velocity=True, add_emotion=True, add_tempo=True,
          num_emotion=4, event_pos=2)),
    ('events/stage1/pop1k7_events/full_song_chorder_{}',
     dict(add_velocity=True, add_emotion=True, add_tempo=True,
          num_emotion=4, event_pos=1)),
    ('events/stage1/emopia_events/full_song_chord11_{}',
     dict(add_velocity=True, add_emotion=True, add_tempo=True,
          num_emotion=4, event_pos=1)),
]


def main(argv=None):
    parser = argparse.ArgumentParser(description='events -> dictionary.pkl')
    required = parser.add_argument_group('required arguments')
    required.add_argument('-r', '--representation', required=True,
                          choices=['remi', 'functional'])
    parser.add_argument('-e', '--num_emotion', default=None, type=int,
                        help='override the per-corpus emotion count '
                             '(reference events2words.py -e flag)')
    parser.add_argument('--root', default='.')
    args = parser.parse_args(argv)
    relative = args.representation == 'functional'

    for template, kwargs in CORPORA:
        root = os.path.join(args.root, template.format(args.representation))
        if not os.path.isdir(os.path.join(root, 'events')):
            print('skip (missing):', root)
            continue
        opts = dict(kwargs)                  # never mutate the CORPORA table
        event_pos = opts.pop('event_pos')
        if args.num_emotion is not None:
            opts['num_emotion'] = args.num_emotion
        path = build_dictionary_from_dir(root, event_pos=event_pos,
                                         relative=relative, **opts)
        print('wrote', path)


if __name__ == '__main__':
    main()
