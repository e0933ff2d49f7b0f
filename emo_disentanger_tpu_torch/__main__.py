"""Master CLI dispatch: ``python -m emo_disentanger_tpu_torch <command> ...``
(port of ``emo_disentanger_tpu/__main__.py``, with the commands the port
has)."""

import sys

COMMANDS = {
    'train-stage1': ('emo_disentanger_tpu_torch.cli.train_stage1', 'stage-1 training'),
    'train-stage2': ('emo_disentanger_tpu_torch.cli.train_stage2', 'stage-2 training'),
    'infer-stage1': ('emo_disentanger_tpu_torch.cli.inference_stage1', 'stage-1 generation'),
    'infer-stage2': ('emo_disentanger_tpu_torch.cli.inference_stage2', 'stage-2 generation'),
    'events2words': ('emo_disentanger_tpu_torch.cli.events2words', 'vocabulary build'),
    'evaluate': ('emo_disentanger_tpu_torch.cli.evaluate', 'objective generation metrics'),
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ('-h', '--help', 'help'):
        print('usage: python -m emo_disentanger_tpu_torch <command> [args]\n')
        for name, (_, desc) in COMMANDS.items():
            print(f'  {name:<14} {desc}')
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f'unknown command {cmd!r}; try --help')
        return 1
    import importlib
    mod = importlib.import_module(COMMANDS[cmd][0])
    mod.main(argv[1:])
    return 0


if __name__ == '__main__':
    sys.exit(main())
