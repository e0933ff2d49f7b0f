"""CLI: stage-2 training (port of ``emo_disentanger_tpu/cli/train_stage2.py``;
reference ``stage2_accompaniment/train.py:196-212``): ``-m/--model_type``,
``-c``, ``-r`` and ``--device``.

    python -m emo_disentanger_tpu_torch.cli.train_stage2 -m performer \\
        -c pop1k7_pretrain.yaml -r functional
    python -m emo_disentanger_tpu_torch.cli.train_stage2 -m gpt2 \\
        -c pop1k7_pretrain_gpt2.yaml -r functional

``EMODIS_HL_ATTN=1`` in the environment trains the Performer in the
heads-last attention layout.  A bare config name is looked up among the JAX
package's stage-2 YAMLs, read by path (this package imports nothing of it).
"""

import argparse
import os

CONFIG_DIR = os.path.join(os.path.dirname(__file__), '..', '..',
                          'emo_disentanger_tpu', 'configs', 'stage2')
KNOWN = ['pop1k7_pretrain.yaml', 'pop1k7_pretrain_gpt2.yaml',
         'emopia_finetune.yaml', 'emopia_finetune_gpt2.yaml']


def resolve_config(name: str) -> str:
    if os.path.exists(name):
        return name
    cand = os.path.normpath(os.path.join(CONFIG_DIR, os.path.basename(name)))
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError(name)


def main(argv=None):
    parser = argparse.ArgumentParser(description='stage-2 (embellish) training')
    required = parser.add_argument_group('required arguments')
    required.add_argument('-m', '--model_type', required=True,
                          choices=['performer', 'gpt2'])
    required.add_argument('-c', '--configuration', required=True,
                          help='training config YAML (one of {} or a path)'
                          .format(KNOWN))
    required.add_argument('-r', '--representation', required=True,
                          choices=['remi', 'functional'])
    parser.add_argument('--max_epoch', type=int, default=None)
    parser.add_argument('--n_devices', type=int, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from ..train import train_stage2
    return train_stage2.run(resolve_config(args.configuration),
                            args.representation, args.model_type,
                            max_epoch_override=args.max_epoch,
                            n_devices=args.n_devices, seed=args.seed,
                            device=args.device)


if __name__ == '__main__':
    main()
