"""The port's stage-2 training driver on the CPU: ``run`` on a synthetic
corpus writes ``log.txt`` / ``valloss.txt`` in the reference formats and an
``ep001_loss*_params.pt`` checkpoint, and a second run resumes from it; the
CLI runs the same from a YAML file, for either backbone."""

import math
import os
import pickle
import re

import pytest
import torch
import yaml

from helpers import write_stage2_corpus

from emo_disentanger_tpu_torch.cli import train_stage2 as cli
from emo_disentanger_tpu_torch.train import train_stage2

VALLOSS_RE = re.compile(
    r'^ep(\d{3}) \| loss: \d+\.\d{3} \| valloss: \d+\.\d{3} \(±\d+\.\d{3}\) \| '
    r'total_acc: \d\.\d{3} \| chord_acc: \d\.\d{3} \| melody_acc: \d\.\d{3} \| '
    r'others_acc: \d\.\d{3}$')


@pytest.fixture(scope='module')
def config(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('run'))
    events_dir, vocab_path, names = write_stage2_corpus(root, n_pieces=5)
    splits = {}
    for split, ns in (('train', names[:3]), ('valid', names[3:])):
        splits[split] = os.path.join(root, f'{split}.pkl')
        with open(splits[split], 'wb') as f:
            pickle.dump(ns, f)
    return {
        'data_loader': {'batch_size': 2, 'data_path': events_dir,
                        'train_split': splits['train'], 'val_split': splits['valid'],
                        'vocab_path': vocab_path},
        'model': {'d_embed': 32, 'd_ff': 64, 'd_model': 32,
                  'feature_map': {'n_dims': 16}, 'max_len': 96, 'n_head': 2,
                  'n_layer': 2, 'use_segemb': True, 'n_segment_types': 2},
        'training': {'ckpt_dir': os.path.join(root, 'ckpt_{}'), 'ckpt_interval': 1,
                     'log_interval': 1, 'feat_redraw_prob': 0.5, 'lr': 1e-3,
                     'lr_scheduler': {'T_max': 100, 'eta_min': 1e-4},
                     'num_epochs': 2, 'warmup_steps': 2,
                     'trained_params': None, 'trained_optim': None},
    }


def test_run_writes_logs_and_checkpoints_and_resumes(config, monkeypatch):
    out = train_stage2.run(config, 'functional', device='cpu')
    assert out['steps'] == 4 and len(out['step_seconds']) == 4
    assert all(math.isfinite(x) for x in out['step_losses'])
    ckpt = out['ckpt_dir']
    assert ckpt.endswith('ckpt_functional')
    log = open(os.path.join(ckpt, 'log.txt')).read().splitlines()
    assert log[0] == '{:4} {:8} {:12} {:12} {:12}'.format(
        'ep', 'steps', 'ce_loss', 'ep_time', 'total_time')
    assert len(log) == 1 + 4 + 2 and log[-1].split()[:2] == ['2', '4']
    val = open(os.path.join(ckpt, 'valloss.txt')).read().splitlines()
    assert [VALLOSS_RE.match(line).group(1) for line in val] == ['001', '002']
    params = sorted(os.listdir(os.path.join(ckpt, 'params')))
    assert len(params) == 4 and params[0].startswith('ep001_loss')
    assert params[0].endswith('_optim.pt') and params[1].endswith('_params.pt')

    # resume: the model starts from the saved params, Adam from its state
    saved = os.path.join(ckpt, 'params', params[3])
    seen = {}
    real_params, real_optim = train_stage2.load_params, train_stage2.load_optimizer

    def load_params(model, path):
        real_params(model, path)
        seen['params'] = {k: v.clone() for k, v in model.state_dict().items()}

    def load_optimizer(opt, path):
        seen['optim'] = real_optim(opt, path)
        return seen['optim']
    monkeypatch.setattr(train_stage2, 'load_params', load_params)
    monkeypatch.setattr(train_stage2, 'load_optimizer', load_optimizer)
    resumed = dict(config, training=dict(
        config['training'], num_epochs=1, trained_params=saved,
        trained_optim=saved.replace('_params.pt', '_optim.pt')))
    out2 = train_stage2.run(resumed, 'resumed', device='cpu')
    want = torch.load(saved, weights_only=True)
    assert seen['optim'] is True
    assert all(torch.equal(seen['params'][k], want[k]) for k in want)
    assert out2['steps'] == 2 and all(math.isfinite(x) for x in out2['step_losses'])


def test_cli_trains_from_yaml_on_cpu(config, tmp_path):
    path = str(tmp_path / 'tiny.yaml')
    cfg = dict(config, training=dict(config['training'], num_epochs=1,
                                     ckpt_dir=str(tmp_path / 'ck_{}')))
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    out = cli.main(['-m', 'performer', '-c', path, '-r', 'remi', '--device', 'cpu'])
    assert out['steps'] == 2 and out['ckpt_dir'] == str(tmp_path / 'ck_remi')
    assert sorted(os.listdir(out['ckpt_dir'])) == [
        'config.yaml', 'log.txt', 'params', 'valloss.txt']
    out = cli.main(['-m', 'gpt2', '-c', path, '-r', 'functional', '--device',
                    'cpu'])
    assert out['steps'] == 2 and out['ckpt_dir'] == str(tmp_path / 'ck_functional')
    assert sorted(os.listdir(out['ckpt_dir'])) == [
        'config.yaml', 'log.txt', 'params', 'valloss.txt']
