"""GPT-2 at the Performer check's learning rate: the port's train step
against JAX's optax step on the CPU.

On the card, eight f32 GPT-2 steps on one batch at lr 1e-3 (warmup 2) rose
instead of falling, so ``chip_smoke.py`` checks GPT-2 at the config's 1e-4.
Here both frameworks take the same eight steps from one set of numpy
weights at reduced width: if their loss curves agree, what the card showed
is the model's at that rate, not a fault of the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from emo_disentanger_tpu.train import trainer as jtr
from emo_disentanger_tpu_torch.train import trainer as ttr
from torch_port_helpers import gpt2_pair, one_torch_thread  # noqa: F401

V = 23
PAD = V - 1
STEPS = 8
# float order alone: the curves agreed to 5.2e-6 at lr 1e-3 and 8.0e-7 at
# 1e-4 when this was written (the updates compound the differences)
LOSS_RTOL = 1e-4


def _batch(B=2, L=48):
    rng = np.random.RandomState(8)
    tgt = rng.randint(0, V - 1, (B, L))
    tgt[rng.rand(B, L) < 0.2] = PAD
    return {'dec_inp': rng.randint(0, V - 1, (B, L)), 'dec_tgt': tgt,
            'track_mask': rng.randint(0, 2, (B, L)),
            'chord_idx': rng.randint(0, 2, (B, L)),
            'melody_idx': rng.randint(0, 2, (B, L))}


@pytest.mark.parametrize('max_lr', [1e-3, 1e-4])
def test_gpt2_fixed_batch_curve_matches_jax(max_lr):
    """The fixed-batch check of chip_smoke.py (8 steps, warmup 2, decay to
    max_lr / 10 over 100) in both frameworks: the curves agree step by step."""
    jm, jp, tm = gpt2_pair(V, seed=6, n_layer=4, d_model=128, d_ff=256,
                           d_embed=128)
    cfg = dict(max_lr=max_lr, min_lr=max_lr / 10, warmup_steps=2,
               lr_decay_steps=100)
    jopt = jtr.make_optimizer(jtr.OptimizerConfig(**cfg))
    state = jtr.init_train_state(jp, jopt)
    jstep = jtr.make_train_step(jtr.stage2_gpt2_loss_fn(jm, PAD), jopt,
                                mesh=None, donate=False)
    tstep = ttr.make_train_step(ttr.stage2_gpt2_loss_fn(tm, PAD), tm,
                                ttr.make_optimizer(tm.parameters(),
                                                   ttr.OptimizerConfig(**cfg)))
    batch = _batch()
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    tb = ttr.batch_to_device(batch, 'cpu')
    want, got = [], []
    for i in range(STEPS):
        state, jl, _ = jstep(state, jb, jax.random.PRNGKey(i), {})
        want.append(float(jl))
        got.append(float(tstep(tb, {})[0]))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert all(np.isfinite(got)) and np.mean(got[-2:]) < np.mean(got[:2])
