"""CLI: stage-2 generation (port of ``emo_disentanger_tpu/cli/inference_stage2.py``;
reference ``stage2_accompaniment/inference.py:330-355``): ``-m``, ``-c``,
``-r``, ``-i``, ``-o``, ``-p`` and ``--device``.

    python -m emo_disentanger_tpu_torch infer-stage2 -m performer \\
        -c emopia_finetune.yaml -r functional --batch 16 --serve

A bare config name is looked up among the port's own stage-2 YAMLs
(``configs/stage2/``, copies of the JAX package's).
"""

import argparse

from .train_stage2 import resolve_config


def main(argv=None):
    parser = argparse.ArgumentParser(description='stage-2 (embellish) generation')
    required = parser.add_argument_group('required arguments')
    required.add_argument('-m', '--model_type', required=True,
                          choices=['performer', 'gpt2'])
    required.add_argument('-c', '--configuration', required=True)
    required.add_argument('-r', '--representation', required=True,
                          choices=['remi', 'functional'])
    parser.add_argument('-i', '--inference_params',
                        default='best_weight/Functional-two/'
                                'emopia_acccompaniment_finetune/ep300_loss0.338_params.pt')
    parser.add_argument('-o', '--output_dir',
                        default='generation/emopia_functional_two')
    parser.add_argument('-p', '--play_midi', default=False, action='store_true')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batch', type=int, default=0,
                        help='batched jobs (both backbones; GPT-2 '
                             're-anchors its window inside the loop)')
    parser.add_argument('--serve', default=False, action='store_true',
                        help='continuous batching: stream ALL jobs through '
                             '--batch slots with refill-on-finish '
                             '(faster on mixed-length file sets)')
    parser.add_argument('--gpt2_cache_len', type=int, default=4096,
                        help='GPT-2 batched decode: KV-cache capacity '
                             '(re-anchor headroom; must cover '
                             'gpt2_window + max bar tokens)')
    parser.add_argument('--gpt2_window', type=int, default=2048,
                        help='GPT-2 batched decode: window re-anchor width '
                             '(reference inference.py:250-257 uses 2048)')
    parser.add_argument('--gpt2_tiers', default='',
                        help='GPT-2 batched decode cache LADDER: comma-'
                             'separated ascending cache sizes below '
                             'gpt2_cache_len (e.g. "1024,2048"); streams '
                             'are bit-identical to a single big cache')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    tiers = ([int(t) for t in args.gpt2_tiers.split(',') if t.strip()]
             or None)

    from ..infer import run_stage2
    return run_stage2.run(resolve_config(args.configuration),
                          args.representation, args.model_type,
                          inference_params=args.inference_params,
                          output_dir=args.output_dir,
                          play_midi=args.play_midi, seed=args.seed,
                          batch_size=args.batch, serve=args.serve,
                          gpt2_cache_len=args.gpt2_cache_len,
                          gpt2_window=args.gpt2_window,
                          gpt2_tiers=tiers, device=args.device)


if __name__ == '__main__':
    main()
