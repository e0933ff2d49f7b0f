"""Stage-2 training driver (port of ``emo_disentanger_tpu/train/train_stage2.py``;
reference ``stage2_accompaniment/train.py``).

Either stage-2 backbone on one device: YAML config (or a dict of the same
shape) -> datasets -> ``MusicPerformer`` or ``MusicGPT2`` -> train/eval
steps -> per-interval ``ep{N}_loss{L}_params.pt`` / ``_optim.pt``
checkpoints (the model's state dict under the reference checkpoint's
names) -> ``log.txt`` and ``valloss.txt`` in the reference formats.

* Performer: the FAVOR+ feature matrices are redrawn before a step with the
  configured probability (reference ``feat_redraw_prob``,
  ``train.py:57,239``), from a ``torch.Generator``.  ``EMODIS_HL_ATTN=1``
  selects the heads-last attention layout (``models/performer.py``).
* GPT-2: no side inputs; the GPT-2 configs accumulate gradients over
  ``accum_steps: 2`` micro-batches.  Training runs the einsum attention
  (attention dropout); the validation forwards run in ``eval()`` mode and
  so take the flash-attention kernel on CUDA where ``models/gpt2.py``'s
  dispatch sends them (L >= 512, L % 128 == 0).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional, Union

import numpy as np
import torch

from ..core.vocab import Vocab
from ..data.datasets import Stage2Dataset
from ..models.gpt2 import MusicGPT2
from ..models.performer import MusicPerformer
from ..utils.device import resolve_device
from ..utils.io import load_yaml, pickle_load
from ..utils.logging import EpochLogger, write_valloss_line
from .checkpoint import (
    PARAMS, gc_checkpoints, load_optimizer, load_params, save_checkpoint,
)
from .trainer import (
    OptimizerConfig, batch_to_device, finalize_accuracy, make_eval_step,
    make_optimizer, make_train_step, neutralize_pad_rows,
    stage2_gpt2_loss_fn, stage2_performer_loss_fn,
)


def build_model_and_params(config: dict, vocab: Vocab, model_type: str = 'performer',
                           seed: int = 0, *, device='cuda',
                           compute_dtype: Optional[torch.dtype] = None):
    """(model, omegas): the ``model_type`` backbone of ``config['model']``
    with the reference initialization drawn from ``seed`` and float32
    parameters, computing in ``compute_dtype`` (bf16 when the config says
    ``compute_dtype: bfloat16``), and, for the Performer, its first omegas
    (None for GPT-2)."""
    if model_type not in ('performer', 'gpt2'):
        raise ValueError(f'unsupported model type {model_type!r}')
    mconf = config['model']
    if compute_dtype is None and config.get('compute_dtype') == 'bfloat16':
        compute_dtype = torch.bfloat16
    common = dict(
        n_token=vocab.size, n_layer=mconf['n_layer'], n_head=mconf['n_head'],
        d_model=mconf['d_model'], d_ff=mconf['d_ff'], d_embed=mconf['d_embed'],
        use_segment_emb=mconf['use_segemb'],
        n_segment_types=mconf.get('n_segment_types', 2),
        compute_dtype=compute_dtype, device=device,
        generator=torch.Generator().manual_seed(seed))
    if model_type == 'gpt2':
        return MusicGPT2(**common), None
    model = MusicPerformer(favor_dims=mconf['feature_map']['n_dims'], **common)
    omegas = model.draw_omegas(torch.Generator().manual_seed(seed + 7))
    return model, omegas


def load_pretrained_params(model: torch.nn.Module, path: str) -> None:
    """Load a reference state dict of either backbone (``.pt``) or a port
    checkpoint (its ``_params.pt`` or stem) into ``model`` by name, as
    ``train_stage1.load_pretrained_params`` does for stage 1.  Entries the
    model has no place for are dropped, as the JAX converters drop them
    (``train/convert_pt.py:9,28``: the reference Performer keeps its
    feature matrices as ``feature_map.omega`` buffers, which the port draws
    as an input); every entry of the model must be in the file."""
    file = path if path.endswith('.pt') else path + PARAMS
    state = torch.load(file, map_location='cpu', weights_only=True)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f'{file} lacks {len(missing)} of the model\'s entries, '
                       f'e.g. {missing[:3]}')
    model.load_state_dict({k: state[k] for k in own})


def run(config: Union[str, dict], representation: str,
        model_type: str = 'performer', *,
        max_epoch_override: Optional[int] = None,
        max_batches_per_epoch: Optional[int] = None,
        n_devices: Optional[int] = None, seed: int = 0,
        device='cuda') -> dict:
    """Train as the config says.  ``config`` is a YAML path or a dict of
    the same shape.  Returns the last epoch's mean training loss, the step
    count, the checkpoint directory, and every step's loss and seconds on
    the host clock (the step ends by reading its loss, which waits for the
    device).  Runs on CUDA unless ``device='cpu'`` is given."""
    dev = resolve_device(device)
    if n_devices not in (None, 1):
        raise NotImplementedError('the port trains on one device')
    config_path = None
    if not isinstance(config, dict):
        config_path = str(config)
        config = load_yaml(config_path)
    tconf, dconf = config['training'], config['data_loader']
    ckpt_dir = tconf['ckpt_dir'].format(representation)

    vocab = Vocab.load(dconf['vocab_path'].format(representation))
    max_len = config['model']['max_len']
    data_dir = dconf['data_path'].format(representation)
    dset = Stage2Dataset(data_dir, vocab, pieces=pickle_load(dconf['train_split']),
                         model_dec_seqlen=max_len, seed=seed)
    val_dset = Stage2Dataset(data_dir, vocab, pieces=pickle_load(dconf['val_split']),
                             model_dec_seqlen=max_len, seed=seed)

    model, omegas = build_model_and_params(config, vocab, model_type, seed,
                                           device=dev)
    if tconf.get('trained_params'):
        load_params(model, tconf['trained_params'])
    optimizer = make_optimizer(model.parameters(), OptimizerConfig(
        max_lr=float(tconf['lr']), min_lr=float(tconf['lr_scheduler']['eta_min']),
        warmup_steps=tconf['warmup_steps'],
        lr_decay_steps=tconf['lr_scheduler']['T_max'],
        accum_steps=tconf.get('accum_steps', 1)))
    if tconf.get('trained_optim'):
        load_optimizer(optimizer, tconf['trained_optim'])

    performer = model_type == 'performer'
    loss_fn = (stage2_performer_loss_fn if performer
               else stage2_gpt2_loss_fn)(model, vocab.pad_id)
    train_step = make_train_step(loss_fn, model, optimizer)
    eval_step = make_eval_step(loss_fn, model)

    os.makedirs(ckpt_dir, exist_ok=True)
    if config_path is not None:
        shutil.copy(config_path, os.path.join(ckpt_dir, 'config.yaml'))
    else:
        with open(os.path.join(ckpt_dir, 'config.json'), 'w') as f:
            json.dump(config, f, indent=1)
    logger = EpochLogger(os.path.join(ckpt_dir, 'log.txt'))

    batch_size = dconf['batch_size']
    redraw_prob = tconf.get('feat_redraw_prob', 0.0)
    max_epoch = max_epoch_override or tconf['num_epochs']
    torch.manual_seed(seed + 1)                     # the dropout masks
    omega_gen = torch.Generator().manual_seed(seed + 1)
    host_rng = np.random.RandomState(seed + 2)
    train_steps = 0
    step_losses, step_seconds = [], []
    recons_loss = float('nan')

    for ep in range(max_epoch):
        t0 = time.time()
        loss_sum, n_samples = 0.0, 0
        for bidx, batch in enumerate(dset.batches(batch_size, shuffle=True)):
            if max_batches_per_epoch and bidx >= max_batches_per_epoch:
                break
            bsz = batch['dec_inp'].shape[0]
            batch = batch_to_device(
                neutralize_pad_rows(batch, batch_size, vocab.pad_id), dev)
            if performer and host_rng.random() <= redraw_prob:
                omegas = model.draw_omegas(omega_gen)
            t_step = time.time()
            loss, _ = train_step(batch, {'omegas': omegas} if performer else {})
            loss = float(loss)
            step_seconds.append(time.time() - t_step)
            step_losses.append(loss)
            train_steps += 1
            loss_sum += loss * bsz
            n_samples += bsz
            if train_steps % tconf['log_interval'] == 0:
                logger.log(ep + 1, train_steps, loss_sum / n_samples,
                           time.time() - t0)
        recons_loss = loss_sum / max(n_samples, 1)

        if (ep + 1) % tconf['ckpt_interval'] == 0:
            params_dir = os.path.join(ckpt_dir, 'params')
            save_checkpoint(params_dir, ep + 1, recons_loss, model, optimizer)
            if tconf.get('ckpt_keep_last', 0):
                gc_checkpoints(params_dir, tconf['ckpt_keep_last'])

        # validate every epoch (reference val_interval = 1)
        val_losses, acc_sums = [], None
        for batch in val_dset.batches(batch_size, shuffle=False):
            batch = batch_to_device(
                neutralize_pad_rows(batch, batch_size, vocab.pad_id), dev)
            loss, aux = eval_step(batch, {'omegas': omegas} if performer else {})
            val_losses.append(float(loss))
            aux = {k: float(v) for k, v in aux.items()}
            acc_sums = aux if acc_sums is None else \
                {k: acc_sums[k] + aux[k] for k in aux}
        write_valloss_line(os.path.join(ckpt_dir, 'valloss.txt'), ep + 1,
                           recons_loss, float(np.mean(val_losses)),
                           float(np.std(val_losses)), finalize_accuracy(acc_sums))
        logger.log(ep + 1, train_steps, recons_loss, time.time() - t0)

    return {'loss': recons_loss, 'steps': train_steps, 'ckpt_dir': ckpt_dir,
            'step_losses': step_losses, 'step_seconds': step_seconds}
