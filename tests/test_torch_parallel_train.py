"""Multi-device training of the port on the CPU, with gloo ranks standing in
for devices (``torch_parallel_ranks``), against the port's one-process run
and JAX's dp-only run on the virtual 8-device mesh.

* Three Adam steps at dp=2, dp=2 x tp=2 and dcn=2 x dp=2 (dropout 0, f32)
  on batches whose ranks hold unequal PAD counts (the last two rows are all
  PAD, as ``neutralize_pad_rows`` leaves a short batch): the losses and the
  final parameters track both references within the tolerance of JAX's own
  dp x tp test (``tests/test_tp_sharding.py:140``).  The clip is set below
  the gradients' global norm, so every step clips, on the global norm.
* The Performer (both attention layouts) and GPT-2 forwards at tp=2
  equal the replicated port forward and JAX's ``shard_params`` forward
  within JAX's tolerance (``tests/test_tp_sharding.py:78,94``).
* Two stage-1 segmented steps at dp=2 (XL memories carried, one row
  all PAD): the losses, each rank's memories and the parameters track the
  one-process run.
* ``train_stage2.run`` and ``train_stage1.run`` at ``n_devices=2``: only
  rank 0 writes, and the logged losses equal the one-process run's.
* The refusals: a world that differs from ``n_devices``, a backend that
  differs from the group's, a world that tp*dcn does not divide, and
  parameters that differ between replicas.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from emo_disentanger_tpu.parallel.mesh import make_mesh as jax_mesh
from emo_disentanger_tpu.parallel.mesh import shard_batch as jax_shard_batch
from emo_disentanger_tpu.parallel.sharding_rules import (
    shard_params as jax_shard_params)
from emo_disentanger_tpu.train import trainer as jtr
from emo_disentanger_tpu_torch.convert import flax_performer_to_torch
from emo_disentanger_tpu_torch.parallel.sharding_rules import (
    FUSED, _out_dim, placement_report)
from emo_disentanger_tpu_torch.train import train_stage1, train_stage2
from helpers import write_stage1_corpus, write_stage2_corpus
from test_torch_txl import TXL_SMALL, txl_pair
from torch_port_helpers import SMALL, gpt2_pair, model_pair

V = 48                 # a vocabulary tp=2 divides: the head is sharded too
PAD = V - 1
# clip_norm below the first steps' global gradient norms (asserted)
CFG = dict(max_lr=1e-3, min_lr=1e-4, warmup_steps=1, lr_decay_steps=100,
           clip_norm=0.02)
TRAIN_TOL = dict(rtol=2e-4, atol=2e-5)      # tests/test_tp_sharding.py:140
FWD_TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_tp_sharding.py:78,94


def _batches():
    rng = np.random.RandomState(0)
    B, L = 8, 24
    out = []
    for _ in range(3):
        tgt = rng.randint(0, V - 1, (B, L))
        tgt[rng.rand(B, L) < 0.3] = PAD
        tgt[6:] = PAD
        out.append({'dec_inp': rng.randint(0, V - 1, (B, L)), 'dec_tgt': tgt,
                    'track_mask': rng.randint(0, 2, (B, L)),
                    'chord_idx': rng.randint(0, 2, (B, L)),
                    'melody_idx': rng.randint(0, 2, (B, L))})
    return out


@pytest.fixture(scope='module')
def setup():
    torch.set_num_threads(1)
    jm, jp, jom, tm, tom = model_pair(V, seed=5)
    batches = _batches()
    state = tm.state_dict()
    one = R.train_steps(R.performer(V, state), tom, batches, CFG, PAD)

    opt = jtr.make_optimizer(jtr.OptimizerConfig(**CFG))
    mesh = jax_mesh(8)
    step = jtr.make_train_step(jtr.stage2_performer_loss_fn(jm, PAD), opt,
                               mesh, donate=False)
    jstate = jtr.init_train_state(jp, opt)
    jlosses = []
    for b in batches:
        jb = jax_shard_batch(mesh, {k: jnp.asarray(v, jnp.int32)
                                    for k, v in b.items()})
        jstate, loss, _ = step(jstate, jb, None, {'omegas': jom})
        jlosses.append(float(loss))
    jparams = flax_performer_to_torch(jax.tree.map(np.asarray, jstate.params),
                                      SMALL['n_layer'])
    return dict(state=state, omegas=tom, batches=batches, one=one,
                jax=(jlosses, jparams), model=tm)


def _assert_tracks(got, want, what):
    losses, params = got
    np.testing.assert_allclose(losses, want[0], err_msg=what, **TRAIN_TOL)
    assert sorted(params) == sorted(want[1])
    for name, p in params.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(want[1][name]),
                                   err_msg=f'{what}: {name}', **TRAIN_TOL)


def _gathered(ranks, model, tp, dp_index=0):
    """The full parameters of data group ``dp_index`` from its tp ranks'
    shards (ranks numbered data-major, tp-minor)."""
    report = placement_report(model, {'tp': tp})
    modules = dict(model.named_modules())
    losses = ranks[dp_index * tp][0]
    full = {}
    for name in ranks[0][1]:
        pieces = [ranks[dp_index * tp + t][1][name] for t in range(tp)]
        role = report[name]
        if role == 'replicated':
            full[name] = pieces[0]
            continue
        path, _, leaf = name.rpartition('.')
        out = 0 if leaf == 'bias' else _out_dim(modules[path])
        dim = out if role == 'col' else 1 - out
        full[name] = R.unshard(pieces, dim, FUSED.get(path.rpartition('.')[2], 1))
    return losses, full


def test_the_clip_acts_on_every_step(setup):
    """The first step's global gradient norm exceeds clip_norm, so the
    steps below all clip (Adam's steps shrink the gradients little)."""
    from emo_disentanger_tpu_torch.train import trainer as ttr
    model = R.performer(V, setup['state'])
    loss, _ = ttr.stage2_performer_loss_fn(model, PAD)(
        ttr.batch_to_device(setup['batches'][0], 'cpu'),
        {'omegas': setup['omegas']})
    loss.backward()
    norm = torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in model.parameters()]))
    assert float(norm) > 5 * CFG['clip_norm']


def test_one_process_tracks_jax_dp(setup):
    _assert_tracks(setup['one'], setup['jax'], 'one process vs JAX dp=8')


def test_dp_tp_and_multi_node_track_one_process_and_jax(setup, tmp_path):
    ranks = R.spawn('leg_train', 4, tmp_path, [(2, 1), (1, 2)], V,
                    setup['state'], setup['omegas'], setup['batches'], CFG,
                    PAD)
    model = setup['model']
    for dp in range(2):                  # dp=2 x tp=2: both data groups
        got = _gathered([r[(2, 1)] for r in ranks], model, 2, dp)
        _assert_tracks(got, setup['one'], f'dp2xtp2 group {dp}')
        _assert_tracks(got, setup['jax'], f'dp2xtp2 group {dp} vs JAX')
    for r, rank in enumerate(ranks):     # dcn=2 x dp=2: rank 3 holds PAD only
        _assert_tracks(rank[(1, 2)], setup['one'], f'dcn2xdp2 rank {r}')
        _assert_tracks(rank[(1, 2)], setup['jax'], f'dcn2xdp2 rank {r} vs JAX')


@pytest.fixture(scope='module')
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('corpora'))

    def splits(names, k):
        out = {}
        for split, ns in (('train', names[:k]), ('valid', names[k:])):
            out[split] = os.path.join(root, f'{split}_{len(names)}.pkl')
            with open(out[split], 'wb') as f:
                pickle.dump(ns, f)
        return out
    s2 = os.path.join(root, 's2')
    events, vocab, names = write_stage2_corpus(s2, n_pieces=5)
    sp = splits(names, 3)
    s2_config = lambda ckpt: {
        'data_loader': {'batch_size': 2, 'data_path': events,
                        'train_split': sp['train'], 'val_split': sp['valid'],
                        'vocab_path': vocab},
        'model': {'d_embed': 32, 'd_ff': 64, 'd_model': 32,
                  'feature_map': {'n_dims': 16}, 'max_len': 96, 'n_head': 2,
                  'n_layer': 2, 'use_segemb': True, 'n_segment_types': 2},
        'training': {'ckpt_dir': ckpt, 'ckpt_interval': 1, 'log_interval': 1,
                     'feat_redraw_prob': 0.5, 'lr': 1e-3,
                     'lr_scheduler': {'T_max': 100, 'eta_min': 1e-4},
                     'num_epochs': 1, 'warmup_steps': 2,
                     'trained_params': None, 'trained_optim': None}}
    s1 = os.path.join(root, 's1')
    events1, vocab1, names1 = write_stage1_corpus(s1, n_pieces=7, n_bars=6)
    sp1 = splits(names1, 5)
    s1_config = lambda ckpt: {
        'pretrained_param_path': None, 'pretrained_optim_path': None,
        'model': {'d_word_embed': 32, 'pre_lnorm': True,
                  'decoder': {'n_layer': 2, 'n_head': 2, 'd_model': 32,
                              'd_ff': 64, 'dropout': 0.0, 'mem_len': 0,
                              'tgt_len': 128}},
        'data': {'data_dir': events1, 'train_split': sp1['train'],
                 'val_split': sp1['valid'], 'vocab_path': vocab1,
                 'batch_size': 2, 'max_n_seg': 1},
        'training': {'trained_steps': 0, 'trained_epochs': 0,
                     'warmup_steps': 1, 'lr_decay_steps': 1000,
                     'max_lr': 3e-3, 'min_lr': 1e-4, 'max_epoch': 1,
                     'val_interval': 1, 'log_interval': 1},
        'output': {'ckpt_dir': ckpt, 'ckpt_interval': 1}}
    return root, s2_config, s1_config


def _log_losses(ckpt, name='log.txt'):
    lines = open(os.path.join(ckpt, name)).read().splitlines()[1:]
    return [float(line.split()[2]) for line in lines]


def _segments():
    """Two stage-1 segments of 4 rows, 16 tokens: row 3 is all PAD (its
    memories stay), row 0 is PAD past token 11."""
    rng = np.random.RandomState(7)
    out = []
    for _ in range(2):
        tgt = rng.randint(0, V - 1, (4, 16))
        tgt[0, 11:] = PAD
        tgt[3] = PAD
        out.append({'dec_inp': rng.randint(0, V - 1, (4, 16)), 'dec_tgt': tgt,
                    'inp_chord': (rng.rand(4, 16) < 0.3).astype(np.int64),
                    'inp_melody': (rng.rand(4, 16) < 0.3).astype(np.int64),
                    'seg_len': np.asarray([11, 16, 9, 0])})
    return out


def test_two_ranks_tp_forwards_dp_training_drivers_and_refusals(
        setup, corpora, tmp_path, monkeypatch):
    root, s2_config, s1_config = corpora
    jm2, jp2, tm2 = gpt2_pair(V, seed=3)
    jm, jp = model_pair(V, seed=5)[:2]
    tokens = (torch.arange(24).reshape(2, 12) * 5) % (V - 1)
    segs = (torch.arange(24).reshape(2, 12) // 7) % 2
    shape = dict(TXL_SMALL, mem_len=8)
    segmented = (txl_pair(V, seed=4, mem_len=8)[2].state_dict(), shape,
                 _segments(), CFG, PAD)
    ranks = R.spawn(
        'leg_two_ranks', 2, tmp_path, V, setup['state'], setup['omegas'],
        tm2.state_dict(), tokens, segs, setup['batches'], CFG, PAD,
        s2_config(os.path.join(root, 'dp_s2')),
        s1_config(os.path.join(root, 'dp_s1')), segmented)

    # tensor-parallel forwards against the replicated ones, and JAX's
    jtp = jax_mesh(8, tp=2)
    jtok, jseg = jnp.asarray(tokens.numpy()), jnp.asarray(segs.numpy())
    with torch.no_grad():
        want = {'performer_tp': setup['model'](tokens, setup['omegas'], segs),
                'gpt2_tp': tm2(tokens, segs)}
    jwant = {'performer_tp': jm.apply(jax_shard_params(jp, jtp), jtok,
                                      jnp.asarray(setup['omegas'].numpy()),
                                      jseg),
             'gpt2_tp': jm2.apply(jax_shard_params(jp2, jtp), jtok, jseg)}
    want['performer_tp_hl'] = want['performer_tp']
    jwant['performer_tp_hl'] = jwant['performer_tp']
    for key in want:
        for rank in ranks:
            np.testing.assert_allclose(rank[key].numpy(), want[key].numpy(),
                                       err_msg=key, **FWD_TOL)
            np.testing.assert_allclose(rank[key].numpy(),
                                       np.asarray(jwant[key]),
                                       err_msg=key, **FWD_TOL)

    one_seg = R.segmented_steps(*segmented)
    for r, rank in enumerate(ranks):
        losses, mems, params = rank['segmented']
        _assert_tracks((losses, params), (one_seg[0], one_seg[2]),
                       f'segmented rank {r}')
        np.testing.assert_allclose(mems.numpy(),
                                   one_seg[1][:, 2 * r:2 * r + 2].numpy(),
                                   err_msg=f'memories rank {r}', **TRAIN_TOL)
        _assert_tracks(rank['dp'], setup['one'], f'dp=2 rank {r}')
        _assert_tracks(rank['dp'], setup['jax'], f'dp=2 rank {r} vs JAX')
        assert 'dec_out_proj.bias' in rank['drift']
        ref = rank['refusals']
        assert 'n_devices=4 but the process group has 2 ranks' in ref['n_devices']
        assert "backend 'nccl' named, but the process group runs 'gloo'" \
            in ref['backend']
        assert 'n_devices=2 not divisible by tp*dcn=4' in ref['divisible']

    # the drivers: one run's files (rank 1 writes none), the global losses
    real = train_stage2.build_model_and_params

    def no_dropout(*a, **kw):
        model, om = real(*a, **kw)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        return model, om
    monkeypatch.setattr(train_stage2, 'build_model_and_params', no_dropout)
    one2 = train_stage2.run(s2_config(os.path.join(root, 'one_s2')),
                            'functional', device='cpu')
    one1 = train_stage1.run(s1_config(os.path.join(root, 'one_s1')),
                            'functional', device='cpu')
    for key, one in (('run2', one2), ('run1', one1)):
        got = [rank[key] for rank in ranks]
        assert got[0]['steps'] == got[1]['steps'] == one['steps'] >= 2
        for g in got:
            np.testing.assert_allclose(g['step_losses'], one['step_losses'],
                                       err_msg=key, **TRAIN_TOL)
        np.testing.assert_allclose(_log_losses(got[0]['ckpt_dir']),
                                   _log_losses(one['ckpt_dir']), rtol=0,
                                   atol=2e-5, err_msg=key)
        assert sorted(os.listdir(got[0]['ckpt_dir'])) == \
            sorted(os.listdir(one['ckpt_dir']))
        assert len(os.listdir(os.path.join(got[0]['ckpt_dir'], 'params'))) == 2
    # stage 2's odd third piece makes a short batch: a PAD row on rank 1
    assert one2['steps'] == 2
