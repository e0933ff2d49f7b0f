"""Stage-1 training of the PyTorch port (CPU) against the JAX package: the
loss and accuracy sums, every parameter's gradient, a segmented step's XL
memories, the dataset's batches; then the port's driver ``train_stage1.run``
on a synthetic corpus, its CLI, and a checkpoint round trip."""

import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.core.vocab import Vocab as JaxVocab
from emo_disentanger_tpu.data.datasets import Stage1Dataset as JaxDataset
from emo_disentanger_tpu.train import trainer as jtr
from emo_disentanger_tpu_torch.cli import train_stage1 as cli
from emo_disentanger_tpu_torch.convert import flax_txl_to_torch
from emo_disentanger_tpu_torch.core.vocab import Vocab
from emo_disentanger_tpu_torch.data.datasets import Stage1Dataset
from emo_disentanger_tpu_torch.train import train_stage1
from emo_disentanger_tpu_torch.train import trainer as ttr
from emo_disentanger_tpu_torch.train.checkpoint import save_checkpoint
from helpers import write_stage1_corpus
from test_torch_txl import TXL_SMALL, txl_pair
from torch_port_helpers import one_torch_thread  # noqa: F401

V = 40
PAD = V - 1
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4            # per parameter, by the norm of the difference


def _batch(seed, B=3, L=16):
    rng = np.random.RandomState(seed)
    inp = rng.randint(0, V - 1, (B, L)).astype(np.int32)
    tgt = rng.randint(0, V - 1, (B, L)).astype(np.int32)
    tgt[0, -5:] = PAD
    inp[0, -4:] = PAD
    return {'dec_inp': inp, 'dec_tgt': tgt,
            'inp_chord': (rng.rand(B, L) < 0.3).astype(np.int32),
            'inp_melody': (rng.rand(B, L) < 0.3).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_loss_accuracy_and_every_gradient_match_jax():
    jm, jp, tm = txl_pair(V, seed=3)
    batch = _batch(1)
    (want, jaux), jg = jax.value_and_grad(
        jtr.stage1_loss_fn(jm, PAD), has_aux=True)(jp, _jax(batch), None, {})
    loss, aux = ttr.stage1_loss_fn(tm, PAD)(_torch(batch), {})
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= LOSS_TOL
    for key, val in jaux.items():
        assert float(aux[key]) == pytest.approx(float(val), abs=LOSS_TOL), key
    ref = flax_txl_to_torch(jax.tree.map(np.asarray, jg), TXL_SMALL['n_layer'])
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, p in tm.named_parameters():
        want_g = ref[name]
        err = float(torch.linalg.vector_norm(p.grad - want_g))
        assert err <= GRAD_TOL * float(torch.linalg.vector_norm(want_g)) + 1e-9, \
            (name, err)


def test_segmented_step_matches_jax():
    """One optimizer step per segment over carried XL memories: two
    segments' losses, the memories after each, and the parameters (to 1e-5,
    1% of one step at lr 1e-3: Adam's g / sqrt(v) turns the float noise of
    a near-zero gradient into up to 1e-3 relative of a step)."""
    jm, jp, tm = txl_pair(V, seed=4, mem_len=8)
    cfg = dict(max_lr=1e-3, min_lr=1e-4, warmup_steps=2, lr_decay_steps=100)
    jopt = jtr.make_optimizer(jtr.OptimizerConfig(**cfg))
    state = jtr.init_train_state(jp, jopt)
    jstep = jtr.make_segmented_train_step(jm, PAD, jopt)
    tstep = ttr.make_segmented_train_step(
        tm, PAD, ttr.make_optimizer(tm.parameters(), ttr.OptimizerConfig(**cfg)))
    D = TXL_SMALL['d_model']
    jmems = jnp.zeros((3, 3, 8, D), jnp.float32)
    tmems = torch.zeros(3, 3, 8, D)
    for seg in range(2):
        b = dict(_batch(20 + seg), seg_len=np.asarray([16, 5, 0], np.int32))
        state, jmems, jl, _ = jstep(state, _jax(b), jmems, None)
        tmems, tl, _ = tstep(_torch(b), tmems)
        assert abs(float(tl) - float(jl)) <= LOSS_TOL
        np.testing.assert_allclose(tmems.numpy(), np.asarray(jmems), rtol=0,
                                   atol=1e-4)
    ref = flax_txl_to_torch(jax.tree.map(np.asarray, state.params),
                            TXL_SMALL['n_layer'])
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('s1'))
    events_dir, vocab_path, names = write_stage1_corpus(root, n_pieces=6,
                                                        n_bars=6)
    return root, events_dir, vocab_path, names


@pytest.mark.parametrize('seqlen,augment,n_seg', [(512, False, 1),
                                                  (40, True, 2)])
def test_dataset_batches_match_jax(corpus, seqlen, augment, n_seg):
    """The same batches for the same seed; the key augmentation draws from
    all twelve keys of a mode, so both vocabularies get every key."""
    _, events_dir, vocab_path, names = corpus
    with open(vocab_path, 'rb') as f:
        e2w, _ = pickle.load(f)
    events = sorted(set(e2w) | {f'Key_{k}' for k in
                                'C C# D D# E F F# G G# A A# B'.split()
                                + 'c c# d d# e f f# g g# a a# b'.split()})
    e2w = {e: i for i, e in enumerate(events)}
    w2e = {i: e for e, i in e2w.items()}
    kw = dict(pieces=names, model_dec_seqlen=seqlen, do_augment=augment,
              max_n_seg=n_seg, seed=7)
    jd = JaxDataset(events_dir, JaxVocab(e2w, w2e), **kw)
    td = Stage1Dataset(events_dir, Vocab(e2w, w2e), **kw)
    assert td.piece_segments == jd.piece_segments
    if n_seg > 1:
        assert any(len(s) == 2 for s in td.piece_segments)
    for _ in range(2):                     # the rng state carries over
        for tb, jb in zip(td.batches(4), jd.batches(4)):
            assert tb.keys() == jb.keys()
            for k in tb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        for tb, jb in zip(td.segment_batches(4), jd.segment_batches(4)):
            for k in tb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def _config(root, events_dir, vocab_path, names, **training):
    splits = {}
    for split, ns in (('train', names[:4]), ('valid', names[4:])):
        splits[split] = os.path.join(root, f'{split}.pkl')
        with open(splits[split], 'wb') as f:
            pickle.dump(ns, f)
    return {
        'pretrained_param_path': None, 'pretrained_optim_path': None,
        'model': {'d_word_embed': 32, 'pre_lnorm': True,
                  'decoder': {'n_layer': 2, 'n_head': 2, 'd_model': 32,
                              'd_ff': 64, 'dropout': 0.1, 'mem_len': 0,
                              'tgt_len': 128}},
        'data': {'data_dir': events_dir, 'train_split': splits['train'],
                 'val_split': splits['valid'], 'vocab_path': vocab_path,
                 'batch_size': 2, 'max_n_seg': 1},
        'training': dict({'trained_steps': 0, 'trained_epochs': 0,
                          'warmup_steps': 1, 'lr_decay_steps': 1000,
                          'max_lr': 3e-3, 'min_lr': 1e-4, 'max_epoch': 6,
                          'val_interval': 1, 'log_interval': 1}, **training),
        'output': {'ckpt_dir': os.path.join(root, 'ckpt_{}'),
                   'ckpt_interval': 3},
    }


def test_run_loss_falls_and_checkpoints(corpus):
    cfg = _config(*corpus)
    out = train_stage1.run(cfg, 'functional', device='cpu')
    losses = out['step_losses']
    assert out['steps'] == 12 and all(math.isfinite(x) for x in losses)
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.1, losses
    ckpt = out['ckpt_dir']
    assert sorted(os.listdir(os.path.join(ckpt, 'params')))[-1].startswith('ep006')
    assert len(open(os.path.join(ckpt, 'valloss.txt')).read().splitlines()) == 6


def test_pretrained_params_round_trip(corpus, tmp_path):
    """A state dict the port saved loads into a fresh model by the
    reference's names, and so does the driver's ``pretrained_param_path``;
    an entry the model has no place for is dropped, a missing one
    refused."""
    root, events_dir, vocab_path, names = corpus
    cfg = _config(root, events_dir, vocab_path, names)
    vocab = Vocab.load(vocab_path)
    src = train_stage1.build_model_and_params(cfg, vocab, seed=1, device='cpu')
    path = save_checkpoint(str(tmp_path), 3, 1.25, src)
    dst = train_stage1.build_model_and_params(cfg, vocab, seed=2, device='cpu')
    assert not torch.equal(dst.dec_out_proj.weight, src.dec_out_proj.weight)
    train_stage1.load_pretrained_params(dst, path)
    for (n, a), (_, b) in zip(src.state_dict().items(), dst.state_dict().items()):
        assert torch.equal(a, b), n
    assert 'decoder.layers.1.pos_ff.CoreNet.3.weight' in dst.state_dict()
    # a reference file also holds the position frequencies as a buffer
    ref = dict(src.state_dict(), **{'decoder.pos_emb.inv_freq': torch.ones(16)})
    torch.save(ref, str(tmp_path / 'reference.pt'))
    fresh = train_stage1.build_model_and_params(cfg, vocab, seed=3, device='cpu')
    train_stage1.load_pretrained_params(fresh, str(tmp_path / 'reference.pt'))
    assert torch.equal(fresh.decoder.r_w_bias, src.decoder.r_w_bias)
    del ref['decoder.r_r_bias']
    torch.save(ref, str(tmp_path / 'short.pt'))
    with pytest.raises(KeyError, match='r_r_bias'):
        train_stage1.load_pretrained_params(fresh, str(tmp_path / 'short.pt'))
    seen = {}
    real = train_stage1.load_pretrained_params

    def spy(model, p):
        real(model, p)
        seen['w'] = model.dec_out_proj.weight.detach().clone()
    try:
        train_stage1.load_pretrained_params = spy
        train_stage1.run(dict(cfg, pretrained_param_path=path,
                              training=dict(cfg['training'], max_epoch=1)),
                         'functional', max_batches_per_epoch=1, device='cpu')
    finally:
        train_stage1.load_pretrained_params = real
    assert torch.equal(seen['w'], src.dec_out_proj.weight)


def test_cli_trains_from_a_yaml(corpus, tmp_path):
    import yaml
    cfg = _config(*corpus, max_epoch=1)
    cfg['output']['ckpt_dir'] = str(tmp_path / 'cli_{}')
    path = tmp_path / 'c.yaml'
    path.write_text(yaml.safe_dump(cfg))
    out = cli.main(['-c', str(path), '-r', 'functional', '--device', 'cpu',
                    '--seed', '3'])
    assert out['steps'] == 2 and os.path.exists(
        os.path.join(out['ckpt_dir'], 'config.yaml'))


def test_bf16_compute_dtype_from_config(corpus):
    cfg = dict(_config(*corpus), compute_dtype='bfloat16')
    model = train_stage1.build_model_and_params(
        cfg, Vocab.load(corpus[2]), device='cpu')
    assert model.compute_dtype == torch.bfloat16
    assert model.dec_out_proj.weight.dtype == torch.float32
    logits, _ = model(torch.zeros(1, 8, dtype=torch.long))
    assert logits.dtype == torch.float32
