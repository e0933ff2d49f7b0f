"""The port's profiling and debug utilities against the JAX package's:
``assert_all_finite`` raises JAX's message, ``checked_train_step`` is
silent on a clean step (which equals the unchecked step) and names a
non-finite loss or gradient, and ``trace`` writes a trace file."""

import os

import numpy as np
import pytest
import torch

from emo_disentanger_tpu.utils import debug as jdebug
from emo_disentanger_tpu_torch.train import trainer as ttr
from emo_disentanger_tpu_torch.utils import debug, profiling
from torch_port_helpers import model_pair

V, PAD = 23, 22


@pytest.mark.parametrize('tree', [
    {'a': {'b': np.array([1.0, np.nan])}, 'c': [np.zeros(2), np.array(np.inf)]},
    {'w': np.ones(3, np.float32), 'i': np.arange(3)}])
def test_assert_all_finite_raises_jax_message(tree):
    def run(fn):
        try:
            fn(tree, 'ckpt')
        except ValueError as e:
            return str(e)
    assert run(debug.assert_all_finite) == run(jdebug.assert_all_finite)


def test_assert_all_finite_names_a_nan_parameter():
    _, _, _, tm, _ = model_pair(V, seed=1)
    debug.assert_all_finite(tm, 'model')
    with torch.no_grad():
        tm.dec_out_proj.bias[3] = float('nan')
    with pytest.raises(ValueError, match=r"non-finite values in model: "
                       r"\[\"\['dec_out_proj.bias'\]\"\]"):
        debug.assert_all_finite(tm, 'model')


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return ttr.batch_to_device({
        'dec_inp': rng.randint(0, V - 1, (2, 16)),
        'dec_tgt': rng.randint(0, V - 1, (2, 16)),
        'track_mask': rng.randint(0, 2, (2, 16)),
        'chord_idx': rng.randint(0, 2, (2, 16)),
        'melody_idx': rng.randint(0, 2, (2, 16))}, 'cpu')


def test_checked_train_step_is_silent_on_a_clean_step_and_names_a_bad_loss():
    runs = []
    for checked in (False, True):
        _, _, _, tm, tom = model_pair(V, seed=2)
        opt = ttr.make_optimizer(tm.parameters(), ttr.OptimizerConfig(
            max_lr=1e-3, warmup_steps=1))
        loss_fn = ttr.stage2_performer_loss_fn(tm, PAD)
        if checked:
            err, (loss, _) = debug.checked_train_step(loss_fn, tm, opt)(
                _batch(), {'omegas': tom})
            assert err.get() is None
            err.throw()
        else:
            loss, _ = ttr.make_train_step(loss_fn, tm, opt)(
                _batch(), {'omegas': tom})
        runs.append((float(loss), {n: p.clone() for n, p in
                                   tm.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for name, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][name]), name

    # an injected inf in the head makes the loss non-finite
    step = debug.checked_train_step(loss_fn, tm, opt)
    with torch.no_grad():
        tm.dec_out_proj.bias[:] = float('-inf')
    before = {n: p.clone() for n, p in tm.named_parameters()}
    err, (loss, _) = step(_batch(1), {'omegas': tom})
    assert not torch.isfinite(loss)
    with pytest.raises(FloatingPointError, match='non-finite loss'):
        err.throw()
    for name, p in tm.named_parameters():
        assert torch.equal(p, before[name]) or name == 'dec_out_proj.bias'
    assert opt.updates == 1


def test_checked_train_step_names_a_nan_gradient():
    _, _, _, tm, tom = model_pair(V, seed=3)
    opt = ttr.make_optimizer(tm.parameters(), ttr.OptimizerConfig())
    loss_fn = ttr.stage2_performer_loss_fn(tm, PAD)

    def nan_grad_loss(batch, extras):
        loss, aux = loss_fn(batch, extras)
        # finite forward (sqrt(0) = 0), NaN gradient (0.5 / sqrt(0) * 0)
        return loss + torch.sqrt(tm.layers[0].linear1.weight * 0.0).sum(), aux
    err, (loss, _) = debug.checked_train_step(nan_grad_loss, tm, opt)(
        _batch(2), {'omegas': tom})
    assert torch.isfinite(loss)
    with pytest.raises(FloatingPointError, match='non-finite gradient'):
        err.throw()
    assert opt.updates == 0


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert any(f.endswith('.json') for f in files), files
