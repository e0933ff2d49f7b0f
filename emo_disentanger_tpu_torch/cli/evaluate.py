"""CLI: objective evaluation of a generation directory (copy of
``emo_disentanger_tpu/cli/evaluate.py``).

    python -m emo_disentanger_tpu_torch evaluate -o <dir>

Groups the event files in an output dir by their emotion label (from the
filename, as stage 2 does) and prints per-emotion aggregates of the
objective correlates (key mode ratio, scale consistency, note density,
velocity/tempo means) — the measurable counterparts of the paper's
valence/arousal claims (Positive -> major mode; higher arousal -> denser,
louder, faster).
"""

import argparse
import json
import os
from collections import defaultdict

import numpy as np


def evaluate_dir(gen_dir: str, suffix: str = '.txt') -> dict:
    from ..infer.metrics import emotion_profile
    from ..infer.pipeline import emotion_candidates_for_file

    groups = defaultdict(list)
    for fname in sorted(os.listdir(gen_dir)):
        if not fname.endswith(suffix) or fname.endswith('roman.txt'):
            continue
        label = None
        # quadrant tags first: stage-2 outputs carry BOTH the stage-1
        # valence tag and the rendered quadrant (e.g. samp_00_Positive_Q1),
        # and the quadrant is the finer label
        for tag in ('Q1', 'Q2', 'Q3', 'Q4', 'Positive', 'Negative'):
            if tag in fname:
                label = tag
                break
        if label is None:
            continue
        with open(os.path.join(gen_dir, fname)) as f:
            events = f.read().split()
        if events:
            groups[label].append(emotion_profile(events))

    report = {}
    for label, profiles in sorted(groups.items()):
        agg = {'n_pieces': len(profiles)}
        agg['major_ratio'] = float(np.mean(
            [p['mode'] == 'major' for p in profiles if p['mode'] is not None] or [0]))
        for key in ('scale_consistency', 'note_density', 'mean_velocity',
                    'mean_tempo', 'pitch_range', 'groove_consistency',
                    'n_bars', 'n_events'):
            agg[key] = float(np.mean([p[key] for p in profiles]))
        report[label] = agg
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description='objective generation metrics')
    parser.add_argument('-o', '--output_dir', required=True)
    parser.add_argument('--suffix', default='.txt')
    args = parser.parse_args(argv)
    report = evaluate_dir(args.output_dir, args.suffix)
    print(json.dumps(report, indent=2))
    return report


if __name__ == '__main__':
    main()
