"""The port's checkpoints: names and ``CKPT_RE`` as in the JAX package,
keep-last/keep-best retention, an exact save -> load round trip of the
model and the optimizer, and reference state dicts with omega entries."""

import os

import numpy as np
import torch

from emo_disentanger_tpu.train import checkpoint as jck
from emo_disentanger_tpu_torch.models import MusicPerformer
from emo_disentanger_tpu_torch.train import checkpoint as tck
from emo_disentanger_tpu_torch.train import trainer as ttr
from torch_port_helpers import SMALL

V = 19
NAMES = ['ep001_loss1.234', 'ep010_loss0.500_params.pt', 'ep002_loss2.000_optim.pt',
         'ep3_loss1.5_params', 'ep004_loss0.250_params', 'foo.pt', 'config.yaml',
         'ep120_loss12.000_params.pt', 'ep001_loss1.234_params.pt.tmp']


def test_names_and_regex_match_jax():
    for name in NAMES:
        a, b = tck.CKPT_RE.match(name), jck.CKPT_RE.match(name)
        assert (a and a.groups()) == (b and b.groups()), name
    for ep, loss in ((1, 1.2345), (12, 0.5), (300, 10.0)):
        assert tck.checkpoint_name(ep, loss) == jck.checkpoint_name(ep, loss)


def _touch(d, ep, loss):
    stem = os.path.join(d, tck.checkpoint_name(ep, loss))
    for suffix in (tck.PARAMS, tck.OPTIM):
        open(stem + suffix, 'w').close()


def test_gc_keeps_last_and_best(tmp_path):
    d = str(tmp_path)
    for ep, loss in enumerate([3.0, 1.0, 2.5, 2.0, 2.2], start=1):
        _touch(d, ep, loss)
    open(os.path.join(d, 'config.yaml'), 'w').close()
    deleted = tck.gc_checkpoints(d, keep_last=2)
    assert sorted(os.path.basename(p) for p in deleted) == [
        'ep001_loss3.000_optim.pt', 'ep001_loss3.000_params.pt',
        'ep003_loss2.500_optim.pt', 'ep003_loss2.500_params.pt']
    assert sorted(os.listdir(d)) == [
        'config.yaml', 'ep002_loss1.000_optim.pt', 'ep002_loss1.000_params.pt',
        'ep004_loss2.000_optim.pt', 'ep004_loss2.000_params.pt',
        'ep005_loss2.200_optim.pt', 'ep005_loss2.200_params.pt']
    assert tck.latest_checkpoint(d) == os.path.join(d, 'ep005_loss2.200_params.pt')
    assert tck.gc_checkpoints(d, keep_last=1, keep_best=False) == [
        os.path.join(d, n) for n in ('ep002_loss1.000_params.pt',
                                     'ep002_loss1.000_optim.pt',
                                     'ep004_loss2.000_params.pt',
                                     'ep004_loss2.000_optim.pt')]


def _model(seed):
    return MusicPerformer(n_token=V, dropout=0.0, device='cpu',
                          generator=torch.Generator().manual_seed(seed), **SMALL)


def _train_one(model, opt):
    gen = torch.Generator().manual_seed(2)
    batch = {'dec_inp': torch.randint(0, V - 1, (2, 24), generator=gen),
             'dec_tgt': torch.randint(0, V, (2, 24), generator=gen),
             'track_mask': torch.randint(0, 2, (2, 24), generator=gen)}
    batch['chord_idx'] = batch['melody_idx'] = batch['track_mask']
    omegas = model.draw_omegas(torch.Generator().manual_seed(3))
    step = ttr.make_train_step(ttr.stage2_performer_loss_fn(model, V - 1),
                               model, opt)
    return float(step(batch, {'omegas': omegas})[0])


def test_save_load_round_trip_is_exact(tmp_path):
    model = _model(0)
    opt = ttr.make_optimizer(model.parameters(), ttr.OptimizerConfig(warmup_steps=2))
    _train_one(model, opt)
    path = tck.save_checkpoint(str(tmp_path), 1, 5.4321, model, opt)
    assert os.path.basename(path) == 'ep001_loss5.432_params.pt'
    assert os.path.exists(path.replace('_params.pt', '_optim.pt'))

    model2 = _model(1)
    opt2 = ttr.make_optimizer(model2.parameters(), ttr.OptimizerConfig(warmup_steps=2))
    assert tck.load_checkpoint(path, model2, opt2)
    for (n, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), n
    assert (opt2.updates, opt2.micro) == (opt.updates, opt.micro) == (1, 0)
    # the restored Adam moments make the next step identical
    assert _train_one(model2, opt2) == _train_one(model, opt)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


def test_reference_state_dict_with_omegas_loads(tmp_path):
    """A reference MusicPerformer state dict carries each layer's
    ``feature_map.omega``; the port drops those keys, as the JAX
    converter does."""
    model = _model(0)
    state = dict(model.state_dict())
    for i in range(SMALL['n_layer']):
        state[f'transformer_decoder.decoder_layers.{i}.attention.'
              'inner_attention.feature_map.omega'] = torch.randn(16, 8)
    path = str(tmp_path / 'reference.pt')
    torch.save(state, path)
    model2 = _model(1)
    tck.load_params(model2, path)
    for (n, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)
