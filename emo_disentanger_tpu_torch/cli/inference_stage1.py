"""CLI: stage-1 generation (port of ``emo_disentanger_tpu/cli/inference_stage1.py``;
reference ``stage1_compose/inference.py:86-114``): ``-c``, ``-r``,
``-m/--mode {lead_sheet,full_song}``, ``-i``, ``-o``, ``-p``, ``-n`` and
``--device``.

    python -m emo_disentanger_tpu_torch infer-stage1 -c emopia_finetune.yaml \\
        -r functional -m lead_sheet --batch 16 --serve

``-r functional`` writes ``.mid``, ``.txt`` and the ``_roman.txt`` that
stage 2 reads; ``-r remi`` (no key step) writes ``.mid`` and ``.txt``, and
stage 2 reads the ``.txt``.  ``-r remi -m full_song`` is the one-stage
baseline.

A bare config name is looked up among the port's own stage-1 YAMLs
(``configs/stage1/``, copies of the JAX package's).
"""

import argparse

from .train_stage1 import resolve_config


def main(argv=None):
    parser = argparse.ArgumentParser(description='stage-1 (compose) generation')
    required = parser.add_argument_group('required arguments')
    required.add_argument('-c', '--configuration', required=True)
    required.add_argument('-r', '--representation', required=True,
                          choices=['remi', 'functional'])
    required.add_argument('-m', '--mode', required=True,
                          choices=['lead_sheet', 'full_song'])
    parser.add_argument('-i', '--inference_params',
                        default='best_weight/Functional-two/'
                                'emopia_lead_sheet_finetune/ep016_loss0.685_params.pt')
    parser.add_argument('-o', '--output_dir',
                        default='generation/emopia_functional_two')
    parser.add_argument('-p', '--play_midi', default=False, action='store_true')
    parser.add_argument('-n', '--n_groups', default=20)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch', type=int, default=0,
                        help='songs decoded at once')
    parser.add_argument('--serve', default=False, action='store_true',
                        help='continuous batching: stream ALL jobs through '
                             '--batch slots with refill-on-finish')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from ..infer import run_stage1
    return run_stage1.run(resolve_config(args.configuration),
                          args.representation, args.mode,
                          inference_params=args.inference_params,
                          output_dir=args.output_dir,
                          n_groups=int(args.n_groups),
                          play_midi=args.play_midi, seed=args.seed,
                          batch_size=args.batch, serve=args.serve,
                          device=args.device)


if __name__ == '__main__':
    main()
