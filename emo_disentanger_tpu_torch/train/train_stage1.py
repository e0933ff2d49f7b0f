"""Stage-1 training driver (port of ``emo_disentanger_tpu/train/train_stage1.py``;
reference ``stage1_compose/train.py``).

YAML config (or a dict of the same shape) -> ``Stage1Dataset`` ->
``PlainTransformer`` -> train/eval steps -> per-interval
``ep{N}_loss{L}_params.pt`` / ``_optim.pt`` checkpoints (the model's state
dict under the reference checkpoint's names) -> ``log.txt`` and
``valloss.txt`` (``log_from_ep{N}.txt`` / ``valloss_from_ep{N}.txt`` when
resuming from ``trained_epochs``) in the reference formats.  Finetuning
starts from ``pretrained_param_path``: a released reference ``.pt`` loads
by name, as does a checkpoint the port wrote.

Over ``n_devices`` ranks the run is data-parallel as stage 2's
(``parallel.mesh.mesh_for``, ``tp=1`` as JAX's driver builds its mesh):
PAD rows pad the batch to a size the data axes divide, each rank trains on
its rows, the logged losses are the global ones and only rank 0 writes
files.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.vocab import Vocab
from ..data.datasets import Stage1Dataset
from ..models.txl import PlainTransformer
from ..parallel.mesh import (
    check_replicas, dp_padded_batch_size, mesh_for, shard_batch)
from ..utils.io import load_yaml, pickle_load
from ..utils.logging import EpochLogger, write_valloss_line
from .checkpoint import PARAMS, gc_checkpoints, load_optimizer, save_checkpoint
from .trainer import (
    OptimizerConfig, batch_to_device, dropout_seed, finalize_accuracy,
    make_eval_step, make_optimizer, make_train_step, neutralize_pad_rows,
    stage1_loss_fn,
)


def build_model_and_params(config: dict, vocab: Vocab, seed: int = 0, *,
                           device='cuda',
                           compute_dtype: Optional[torch.dtype] = None
                           ) -> PlainTransformer:
    """The ``PlainTransformer`` of ``config['model']`` with the JAX
    initialization drawn from ``seed`` and float32 parameters, computing in
    ``compute_dtype`` (bf16 when the config says ``compute_dtype:
    bfloat16``)."""
    mconf = config['model']
    dconf = mconf['decoder']
    if compute_dtype is None and config.get('compute_dtype') == 'bfloat16':
        compute_dtype = torch.bfloat16
    return PlainTransformer(
        vocab.size, d_embed=mconf['d_word_embed'], n_layer=dconf['n_layer'],
        n_head=dconf['n_head'], d_model=dconf['d_model'], d_ff=dconf['d_ff'],
        dropout=dconf['dropout'], pre_lnorm=mconf['pre_lnorm'],
        mem_len=dconf['mem_len'], pad_id=vocab.pad_id,
        compute_dtype=compute_dtype, device=device,
        generator=torch.Generator().manual_seed(seed))


def load_pretrained_params(model: PlainTransformer, path: str) -> None:
    """Load a reference ``PlainTransformer`` state dict or a port
    checkpoint (its ``_params.pt`` or stem) into ``model`` by name.
    Entries the model has no place for are dropped, as the JAX converter
    drops them (``train/convert_pt.py:45-69``; the reference's Transformer-XL
    keeps its position frequencies as a buffer, ``decoder.pos_emb.inv_freq``);
    every entry of the model must be in the file."""
    file = path if path.endswith('.pt') else path + PARAMS
    state = torch.load(file, map_location='cpu', weights_only=True)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f'{file} lacks {len(missing)} of the model\'s entries, '
                       f'e.g. {missing[:3]}')
    model.load_state_dict({k: state[k] for k in own})


def run(config: Union[str, dict], representation: str, *,
        max_epoch_override: Optional[int] = None,
        max_batches_per_epoch: Optional[int] = None,
        n_devices: Optional[int] = None, backend: Optional[str] = None,
        seed: int = 0, device='cuda') -> dict:
    """Train as the config says.  ``config`` is a YAML path or a dict of
    the same shape.  Returns the last epoch's mean training loss, the step
    count, the checkpoint directory, and every step's loss and seconds on
    the host clock (the step ends by reading its loss, which waits for the
    device).  Runs on CUDA unless ``device='cpu'`` is given.
    ``n_devices`` and ``backend`` as in ``train_stage2.run``."""
    dev, mesh = mesh_for(n_devices, backend=backend, device=device)
    lead = mesh is None or dist.get_rank() == 0
    config_path = None
    if not isinstance(config, dict):
        config_path = str(config)
        config = load_yaml(config_path)
    tconf, dconf = config['training'], config['data']
    ckpt_dir = config['output']['ckpt_dir'].format(representation)

    vocab = Vocab.load(dconf['vocab_path'].format(representation))
    tgt_len = config['model']['decoder']['tgt_len']
    data_dir = dconf['data_dir'].format(representation)
    dset = Stage1Dataset(data_dir, vocab, pieces=pickle_load(dconf['train_split']),
                         model_dec_seqlen=tgt_len, seed=seed)
    val_dset = Stage1Dataset(data_dir, vocab, pieces=pickle_load(dconf['val_split']),
                             model_dec_seqlen=tgt_len, seed=seed)

    model = build_model_and_params(config, vocab, seed, device=dev)
    if config.get('pretrained_param_path'):
        load_pretrained_params(model, config['pretrained_param_path'])
    check_replicas(model, mesh)
    optimizer = make_optimizer(model.parameters(), OptimizerConfig(
        max_lr=float(tconf['max_lr']), min_lr=float(tconf['min_lr']),
        warmup_steps=tconf['warmup_steps'],
        lr_decay_steps=tconf['lr_decay_steps']))
    if config.get('pretrained_optim_path'):
        load_optimizer(optimizer, config['pretrained_optim_path'])

    loss_fn = stage1_loss_fn(model, vocab.pad_id)
    train_step = make_train_step(loss_fn, model, optimizer, mesh)
    eval_step = make_eval_step(loss_fn, model, mesh)

    if lead:
        os.makedirs(ckpt_dir, exist_ok=True)
        if config_path is not None:
            shutil.copy(config_path, os.path.join(ckpt_dir, 'config.yaml'))
        else:
            with open(os.path.join(ckpt_dir, 'config.json'), 'w') as f:
                json.dump(config, f, indent=1)
    start_epoch = tconf.get('trained_epochs') or 0
    suffix = '' if start_epoch == 0 else f'_from_ep{start_epoch:03d}'
    logger = (EpochLogger(os.path.join(ckpt_dir, f'log{suffix}.txt'))
              if lead else None)

    batch_size = dconf['batch_size']
    eff_batch_size = dp_padded_batch_size(mesh, batch_size)
    max_epoch = max_epoch_override or tconf['max_epoch']
    torch.manual_seed(dropout_seed(seed, mesh))       # the dropout masks
    train_steps = tconf.get('trained_steps') or 0
    step_losses, step_seconds = [], []
    recons_loss = float('nan')

    for ep in range(start_epoch, max_epoch):
        t0 = time.time()
        loss_sum, n_samples = 0.0, 0
        for bidx, batch in enumerate(dset.batches(batch_size, shuffle=True)):
            if max_batches_per_epoch and bidx >= max_batches_per_epoch:
                break
            bsz = batch['dec_inp'].shape[0]
            batch = batch_to_device(shard_batch(mesh, neutralize_pad_rows(
                batch, eff_batch_size, vocab.pad_id)), dev)
            t_step = time.time()
            loss, _ = train_step(batch, {})
            loss = float(loss)
            step_seconds.append(time.time() - t_step)
            step_losses.append(loss)
            train_steps += 1
            loss_sum += loss * bsz
            n_samples += bsz
            if lead and train_steps % tconf['log_interval'] == 0:
                logger.log(ep + 1, train_steps, loss_sum / n_samples,
                           time.time() - t0)
        recons_loss = loss_sum / max(n_samples, 1)

        if lead and (ep + 1) % config['output']['ckpt_interval'] == 0:
            params_dir = os.path.join(ckpt_dir, 'params')
            save_checkpoint(params_dir, ep + 1, recons_loss, model, optimizer)
            keep = config['output'].get('ckpt_keep_last', 0)
            if keep:
                gc_checkpoints(params_dir, keep)

        if (ep + 1) % tconf['val_interval'] == 0:
            val_losses, acc_sums = [], None
            for batch in val_dset.batches(batch_size, shuffle=False):
                batch = batch_to_device(shard_batch(mesh, neutralize_pad_rows(
                    batch, eff_batch_size, vocab.pad_id)), dev)
                loss, aux = eval_step(batch, {})
                val_losses.append(float(loss))
                aux = {k: float(v) for k, v in aux.items()}
                acc_sums = aux if acc_sums is None else \
                    {k: acc_sums[k] + aux[k] for k in aux}
            if lead:
                write_valloss_line(
                    os.path.join(ckpt_dir, f'valloss{suffix}.txt'), ep + 1,
                    recons_loss, float(np.mean(val_losses)),
                    float(np.std(val_losses)), finalize_accuracy(acc_sums))
        if lead:
            logger.log(ep + 1, train_steps, recons_loss, time.time() - t0)

    return {'loss': recons_loss, 'steps': train_steps, 'ckpt_dir': ckpt_dir,
            'step_losses': step_losses, 'step_seconds': step_seconds}
