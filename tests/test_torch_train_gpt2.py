"""GPT-2 training in the port (CPU) against the JAX package: the loss
function's loss and every parameter's gradient, two Adam steps over four
micro-batches with ``accum_steps=2`` (the GPT-2 configs' value), and
``train_stage2.run`` for GPT-2 on a synthetic corpus, whose checkpoint
loads back by the reference names; then ``run`` for the Performer under
``EMODIS_HL_ATTN=1``, which trains through the heads-last op."""

import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import write_stage2_corpus

from emo_disentanger_tpu.train import trainer as jtr
from emo_disentanger_tpu.train.convert_pt import convert_gpt2_pt
from emo_disentanger_tpu_torch.convert import flax_gpt2_to_torch
from emo_disentanger_tpu_torch.models import MusicGPT2
from emo_disentanger_tpu_torch.models import performer as tperf
from emo_disentanger_tpu_torch.train import train_stage2
from emo_disentanger_tpu_torch.train import trainer as ttr
from torch_port_helpers import ATOL, GPT2_SMALL, RTOL, gpt2_pair, one_torch_thread  # noqa: F401

V = 23
PAD = V - 1
# gradients through two layers: the JAX suite's gradient tolerance
# (tests/test_linear_attention.py:158-175), relative to each tensor's largest
GRAD_RTOL = 2e-3


def _batch(seed, B=2, L=24):
    rng = np.random.RandomState(seed)
    tgt = rng.randint(0, V - 1, (B, L))
    tgt[rng.rand(B, L) < 0.3] = PAD
    return {'dec_inp': rng.randint(0, V - 1, (B, L)), 'dec_tgt': tgt,
            'track_mask': rng.randint(0, 2, (B, L)),
            'chord_idx': rng.randint(0, 2, (B, L)),
            'melody_idx': rng.randint(0, 2, (B, L))}


def _jax(batch):
    return {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def test_gpt2_loss_fn_loss_and_every_gradient_match_jax():
    jm, jp, tm = gpt2_pair(V, seed=3)
    batch = _batch(4)
    (want, jaux), jg = jax.value_and_grad(
        jtr.stage2_gpt2_loss_fn(jm, PAD), has_aux=True)(jp, _jax(batch), None,
                                                        {})
    loss, aux = ttr.stage2_gpt2_loss_fn(tm, PAD)(
        ttr.batch_to_device(batch, 'cpu'), {'ignored': None})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    assert {k: float(v) for k, v in aux.items()} == \
        {k: float(v) for k, v in jaux.items()}
    ref = flax_gpt2_to_torch(jax.tree.map(np.asarray, jg), GPT2_SMALL['n_layer'])
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(ref)
    for name, p in tm.named_parameters():
        got, exp = p.grad.numpy(), ref[name].numpy()
        err = float(np.abs(got - exp).max())
        assert err <= GRAD_RTOL * float(np.abs(exp).max()) + 1e-9, (name, err)


def test_gpt2_adam_steps_with_accumulation_match_jax():
    """Clip 0.5 before Adam, warmup 2, accum_steps 2: four micro-batches
    make two updates, each from the mean of two gradients
    (optax.MultiSteps); dropout 0, so the JAX step's key changes nothing."""
    jm, jp, tm = gpt2_pair(V, seed=5)
    cfg = dict(max_lr=1e-3, min_lr=1e-4, warmup_steps=2, lr_decay_steps=100,
               accum_steps=2)
    jopt = jtr.make_optimizer(jtr.OptimizerConfig(**cfg))
    state = jtr.init_train_state(jp, jopt)
    jstep = jtr.make_train_step(jtr.stage2_gpt2_loss_fn(jm, PAD), jopt,
                                mesh=None, donate=False)
    topt = ttr.make_optimizer(tm.parameters(), ttr.OptimizerConfig(**cfg))
    tstep = ttr.make_train_step(ttr.stage2_gpt2_loss_fn(tm, PAD), tm, topt)
    for i in range(4):
        batch = _batch(10 + i)
        state, jl, _ = jstep(state, _jax(batch), jax.random.PRNGKey(i), {})
        tl, _ = tstep(ttr.batch_to_device(batch, 'cpu'), {})
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, atol=1e-5)
    assert topt.updates == 2 and topt.micro == 0
    ref = flax_gpt2_to_torch(jax.tree.map(np.asarray, state.params),
                             GPT2_SMALL['n_layer'])
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.fixture(scope='module')
def corpus_config(tmp_path_factory):
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
                     'log_interval': 1, 'lr': 1e-3,
                     'lr_scheduler': {'T_max': 100, 'eta_min': 1e-4},
                     'num_epochs': 1, 'warmup_steps': 2, 'accum_steps': 2,
                     'trained_params': None, 'trained_optim': None},
    }


def test_run_trains_gpt2_and_its_checkpoint_loads_back(corpus_config, tmp_path,
                                                        monkeypatch):
    """Two micro-batches make one accumulated update; the logs and an
    ep001 checkpoint are written; the params file loads strictly into a new
    MusicGPT2 and is read by the JAX package's reference converter, so it
    carries the reference GPT-2 names."""
    cfg = dict(corpus_config, training=dict(
        corpus_config['training'], ckpt_dir=str(tmp_path / 'gpt2_{}')))
    updates = []
    real_step = ttr.Optimizer.step

    def step(opt):
        updates.append(real_step(opt))
        return updates[-1]
    monkeypatch.setattr(ttr.Optimizer, 'step', step)
    out = train_stage2.run(cfg, 'functional', 'gpt2', device='cpu')
    assert out['steps'] == 2 and updates == [False, True]
    assert all(math.isfinite(x) for x in out['step_losses'])
    ckpt = out['ckpt_dir']
    assert sorted(os.listdir(ckpt)) == ['config.json', 'log.txt', 'params',
                                        'valloss.txt']
    assert len(open(os.path.join(ckpt, 'valloss.txt')).read().splitlines()) == 1
    files = sorted(os.listdir(os.path.join(ckpt, 'params')))
    assert len(files) == 2 and files[1].startswith('ep001_loss')
    path = os.path.join(ckpt, 'params', files[1])
    assert path.endswith('_params.pt')
    state = torch.load(path, weights_only=True)
    vocab_size = state['dec_out_proj.weight'].shape[0]
    fresh = MusicGPT2(n_token=vocab_size, device='cpu', n_layer=2, n_head=2,
                      d_model=32, d_ff=64, d_embed=32)
    fresh.load_state_dict(state, strict=True)
    assert 'transformer_decoder.1.attn.c_attn.weight' in state
    flat = jax.tree_util.tree_flatten_with_path(convert_gpt2_pt(path, n_layer=2))[0]
    assert len(flat) == len(state)


def test_run_trains_the_heads_last_performer(corpus_config, tmp_path,
                                              monkeypatch):
    """EMODIS_HL_ATTN=1 makes train_stage2.run build the heads-last
    Performer: every layer's attention goes through the heads-last op, none
    through the head-major one, and the losses are finite."""
    monkeypatch.setenv('EMODIS_HL_ATTN', '1')
    calls = {'hl': 0, 'hm': 0}
    real_hl, real_hm = (tperf.favor_causal_attention_heads_last,
                        tperf.favor_causal_attention)

    def hl(*a, **kw):
        calls['hl'] += 1
        return real_hl(*a, **kw)

    def hm(*a, **kw):
        calls['hm'] += 1
        return real_hm(*a, **kw)
    monkeypatch.setattr(tperf, 'favor_causal_attention_heads_last', hl)
    monkeypatch.setattr(tperf, 'favor_causal_attention', hm)
    cfg = dict(corpus_config, training=dict(
        corpus_config['training'], ckpt_dir=str(tmp_path / 'hl_{}'),
        accum_steps=1, feat_redraw_prob=0.5))
    out = train_stage2.run(cfg, 'functional', device='cpu')
    assert out['steps'] == 2 and all(math.isfinite(x) for x in out['step_losses'])
    n_layer = cfg['model']['n_layer']
    assert calls['hm'] == 0 and calls['hl'] == n_layer * (2 + 1)   # + 1 val batch
