"""CLI: stage-1 training (port of ``emo_disentanger_tpu/cli/train_stage1.py``;
reference ``stage1_compose/train.py:191-204``): ``-c/--configuration``,
``-r/--representation``, ``--max_epoch``, ``--seed`` and ``--device``.

    python -m emo_disentanger_tpu_torch.cli.train_stage1 \\
        -c emopia_finetune.yaml -r functional

A bare config name is looked up among the JAX package's stage-1 YAMLs,
read by path (this package imports nothing of it).
"""

import argparse
import os

CONFIG_DIR = os.path.join(os.path.dirname(__file__), '..', '..',
                          'emo_disentanger_tpu', 'configs', 'stage1')
KNOWN = ['hooktheory_pretrain.yaml', 'emopia_finetune.yaml',
         'pop1k7_pretrain.yaml', 'emopia_finetune_full.yaml']


def resolve_config(name: str) -> str:
    if os.path.exists(name):
        return name
    cand = os.path.normpath(os.path.join(CONFIG_DIR, os.path.basename(name)))
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError(name)


def main(argv=None):
    parser = argparse.ArgumentParser(description='stage-1 (compose) training')
    required = parser.add_argument_group('required arguments')
    required.add_argument('-c', '--configuration', required=True,
                          help='training config YAML (one of {} or a path)'
                          .format(KNOWN))
    required.add_argument('-r', '--representation', required=True,
                          choices=['remi', 'functional'])
    parser.add_argument('--max_epoch', type=int, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from ..train import train_stage1
    return train_stage1.run(resolve_config(args.configuration),
                            args.representation,
                            max_epoch_override=args.max_epoch,
                            seed=args.seed, device=args.device)


if __name__ == '__main__':
    main()
