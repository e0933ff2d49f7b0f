"""CLI: train/valid splits (port of ``emo_disentanger_tpu/cli/data_splits.py``;
reference ``representations/data_splits.py``)."""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description='build data splits')
    parser.add_argument('--emopia_split_dir', default='midi_data/EMOPIA+/split')
    parser.add_argument('--hooktheory_events_dir',
                        default='events/stage1/hooktheory_events/'
                                'lead_sheet_chord11_functional/events')
    parser.add_argument('--root', default='.')
    args = parser.parse_args(argv)

    import os
    from ..data.splits import split_emopia, split_hooktheory

    for stage in ('stage1', 'stage2'):
        out = os.path.join(args.root, 'events', stage, 'emopia_events',
                           'data_splits')
        try:
            split_emopia(args.emopia_split_dir, out)
            print('wrote', out)
        except FileNotFoundError as e:
            print('skip emopia ({}):'.format(stage), e)

    out = os.path.join(args.root, 'events', 'stage1', 'hooktheory_events',
                       'data_splits')
    try:
        split_hooktheory(args.hooktheory_events_dir, out)
        print('wrote', out)
    except FileNotFoundError as e:
        print('skip hooktheory:', e)


if __name__ == '__main__':
    main()
