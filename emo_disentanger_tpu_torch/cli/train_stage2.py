"""CLI: stage-2 training (port of ``emo_disentanger_tpu/cli/train_stage2.py``;
reference ``stage2_accompaniment/train.py:196-212``): ``-m/--model_type``,
``-c``, ``-r``, ``--n_devices``, ``--backend`` and ``--device``.

    python -m emo_disentanger_tpu_torch.cli.train_stage2 -m performer \\
        -c pop1k7_pretrain.yaml -r functional
    python -m emo_disentanger_tpu_torch.cli.train_stage2 -m gpt2 \\
        -c pop1k7_pretrain_gpt2.yaml -r functional

A data-parallel run starts one rank a card under torchrun, each rank on
``cuda:LOCAL_RANK``:

    torchrun --nproc_per_node N -m emo_disentanger_tpu_torch train-stage2 \\
        -m performer -c pop1k7_pretrain.yaml -r functional --n_devices N

``EMODIS_HL_ATTN=1`` in the environment trains the Performer in the
heads-last attention layout.  A bare config name is looked up among the
port's own stage-2 YAMLs (``configs/stage2/``, copies of the JAX package's).
"""

import argparse
import os

# the port's own copies of the JAX package's stage-2 YAMLs
CONFIG_DIR = os.path.join(os.path.dirname(__file__), '..', 'configs', 'stage2')
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
    parser.add_argument('--n_devices', type=int, default=None,
                        help='ranks of a data-parallel run (the world size)')
    parser.add_argument('--backend', default='nccl',
                        help="process-group backend a multi-rank run starts "
                        "('nccl', default, one card a rank; or 'gloo')")
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from ..train import train_stage2
    return train_stage2.run(resolve_config(args.configuration),
                            args.representation, args.model_type,
                            max_epoch_override=args.max_epoch,
                            n_devices=args.n_devices, backend=args.backend,
                            seed=args.seed,
                            device=args.device)


if __name__ == '__main__':
    main()
