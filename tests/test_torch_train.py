"""The port's training stack (CPU) against the JAX package: the loss, the
accuracy sums, the LR schedule, the loss and every parameter's gradient,
the parameters after a few optimizer steps (with and without gradient
accumulation), the bf16 first-step loss, and the dropout's semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from emo_disentanger_tpu.models import MusicPerformer as JaxPerformer
from emo_disentanger_tpu.models.txl import masked_cross_entropy as jax_mce
from emo_disentanger_tpu.train import trainer as jtr
from emo_disentanger_tpu.train.schedule import warmup_cosine as jax_schedule
from emo_disentanger_tpu_torch.convert import flax_performer_to_torch
from emo_disentanger_tpu_torch.models.txl import masked_cross_entropy
from emo_disentanger_tpu_torch.train import trainer as ttr
from emo_disentanger_tpu_torch.train.schedule import warmup_cosine
from torch_port_helpers import ATOL, RTOL, SMALL, model_pair

V = 23                 # vocabulary incl. PAD
PAD = V - 1
# gradients through two layers: the JAX suite's gradient tolerance
# (tests/test_linear_attention.py:158-175), relative to each tensor's largest
GRAD_RTOL = 2e-3


def _batch(seed, B=2, L=40):
    rng = np.random.RandomState(seed)
    tgt = rng.randint(0, V - 1, (B, L))
    tgt[rng.rand(B, L) < 0.3] = PAD
    return {'dec_inp': rng.randint(0, V - 1, (B, L)), 'dec_tgt': tgt,
            'track_mask': rng.randint(0, 2, (B, L)),
            'chord_idx': rng.randint(0, 2, (B, L)),
            'melody_idx': rng.randint(0, 2, (B, L))}


def _jax(batch):
    return {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def _torch(batch):
    return ttr.batch_to_device(batch, 'cpu')


def test_masked_cross_entropy_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 7, V).astype(np.float32) * 3
    tgt = rng.randint(0, V, (2, 7))
    tgt[0, :3] = PAD
    want = jax_mce(jnp.asarray(logits), jnp.asarray(tgt), PAD)
    got = masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(tgt), PAD)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    all_pad = torch.full((2, 7), PAD)
    assert float(masked_cross_entropy(torch.from_numpy(logits), all_pad, PAD)) == 0.0


def test_accuracy_sums_and_finalize_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 11, V).astype(np.float32)
    b = _batch(2, B=3, L=11)
    b['dec_tgt'][:, ::2] = logits.argmax(-1)[:, ::2]      # some right
    want = jtr.accuracy_sums(jnp.asarray(logits), jnp.asarray(b['dec_tgt']),
                             jnp.asarray(b['chord_idx']),
                             jnp.asarray(b['melody_idx']), PAD)
    got = ttr.accuracy_sums(torch.from_numpy(logits), torch.from_numpy(b['dec_tgt']),
                            torch.from_numpy(b['chord_idx']),
                            torch.from_numpy(b['melody_idx']), PAD)
    want = {k: float(v) for k, v in want.items()}
    got = {k: float(v) for k, v in got.items()}
    assert got == want
    assert ttr.finalize_accuracy(got) == jtr.finalize_accuracy(want)


def test_warmup_cosine_matches_jax():
    args = (1e-4, 1e-5, 200, 1000)
    want, got = jax_schedule(*args), warmup_cosine(*args)
    for step in (0, 1, 100, 200, 700, 1200):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)


def _grad_close(got, want, what):
    err = float(np.abs(got - want).max())
    assert err <= GRAD_RTOL * float(np.abs(want).max()) + 1e-9, \
        f'{what}: {err:.3e} vs largest {float(np.abs(want).max()):.3e}'


def test_loss_and_every_gradient_match_jax():
    jm, jp, jom, tm, tom = model_pair(V, seed=3)
    batch = _batch(4)
    jloss = jtr.stage2_performer_loss_fn(jm, PAD)
    (want, _), jg = jax.value_and_grad(jloss, has_aux=True)(
        jp, _jax(batch), None, {'omegas': jom})
    loss, _ = ttr.stage2_performer_loss_fn(tm, PAD)(_torch(batch), {'omegas': tom})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    ref = flax_performer_to_torch(jax.tree.map(np.asarray, jg), SMALL['n_layer'])
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        _grad_close(p.grad.numpy(), ref[name].numpy(), name)


@pytest.mark.parametrize('accum,calls', [(1, 3), (2, 6)])
def test_params_after_steps_match_jax(accum, calls):
    """Clip 0.5 before Adam, warmup 2, over ``calls`` micro-batches; with
    ``accum_steps=2`` the mean of two micro-batch gradients makes each of
    the three updates (optax.MultiSteps)."""
    jm, jp, jom, tm, tom = model_pair(V, seed=5)
    cfg = dict(max_lr=1e-3, min_lr=1e-4, warmup_steps=2, lr_decay_steps=100,
               accum_steps=accum)
    jopt = jtr.make_optimizer(jtr.OptimizerConfig(**cfg))
    state = jtr.init_train_state(jp, jopt)
    jstep = jtr.make_train_step(jtr.stage2_performer_loss_fn(jm, PAD), jopt,
                                mesh=None, donate=False)
    topt = ttr.make_optimizer(tm.parameters(), ttr.OptimizerConfig(**cfg))
    tstep = ttr.make_train_step(ttr.stage2_performer_loss_fn(tm, PAD), tm, topt)
    for i in range(calls):
        batch = _batch(10 + i)
        state, jl, _ = jstep(state, _jax(batch), jax.random.PRNGKey(i),
                             {'omegas': jom})
        tl, _ = tstep(_torch(batch), {'omegas': tom})
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, atol=1e-5)
    assert topt.updates == 3 and topt.micro == 0
    ref = flax_performer_to_torch(jax.tree.map(np.asarray, state.params),
                                  SMALL['n_layer'])
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_bf16_first_step_loss_matches_jax():
    """bf16 compute with float32 master weights: the first loss within 5%
    of JAX's bf16 model (tests/test_training.py:213), and the parameters,
    their gradients and Adam's state stay float32 through a step."""
    jm, jp, jom, tm, tom = model_pair(V, seed=7)
    jbf = JaxPerformer(n_token=V, dropout=0.0, dtype=jnp.bfloat16, **SMALL)
    batch = _batch(8)
    (want, _) = jtr.stage2_performer_loss_fn(jbf, PAD)(jp, _jax(batch), None,
                                                       {'omegas': jom})
    tm.compute_dtype = torch.bfloat16
    opt = ttr.make_optimizer(tm.parameters(), ttr.OptimizerConfig(warmup_steps=2))
    step = ttr.make_train_step(ttr.stage2_performer_loss_fn(tm, PAD), tm, opt)
    loss, _ = step(_torch(batch), {'omegas': tom})
    assert abs(float(loss) - float(want)) < 0.05 * max(1.0, float(want))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(t.dtype == torch.float32 for s in opt.adam.state.values()
               for k, t in s.items() if k != 'step')


def test_dropout_sites_and_semantics():
    """1 + 3 * n_layer dropout applications a training forward, none in
    eval(); the drop share and the mean within binomial bounds at rate 0.1
    with 1/0.9 scaling (not JAX's 26/256 quantized rate)."""
    model = TorchPerformerWithDropout()
    calls = []
    for mod in model.modules():
        if isinstance(mod, nn.Dropout):
            mod.register_forward_hook(lambda m, i, o: calls.append(
                bool((o != i[0]).any())))
    tokens = torch.randint(0, V - 1, (2, 16), generator=torch.Generator().manual_seed(0))
    omegas = model.draw_omegas(torch.Generator().manual_seed(1))
    model.train()(tokens, omegas)
    assert len(calls) == 1 + 3 * SMALL['n_layer'] and all(calls)
    calls.clear()
    model.eval()(tokens, omegas)
    assert len(calls) == 1 + 3 * SMALL['n_layer'] and not any(calls)

    n, p = 1 << 20, 0.1
    torch.manual_seed(0)
    out = model.emb_dropout.train()(torch.ones(n))
    dropped = float((out == 0).float().mean())
    sd = (p * (1 - p) / n) ** 0.5
    assert abs(dropped - p) < 5 * sd                # 26/256 would be 5.4 sd off
    values = out.unique().tolist()
    assert len(values) == 2 and values[0] == 0.0
    assert values[1] == pytest.approx(1 / 0.9)
    assert abs(float(out.mean()) - 1.0) < 5 * sd / (1 - p)


def TorchPerformerWithDropout():
    from emo_disentanger_tpu_torch.models import MusicPerformer
    return MusicPerformer(n_token=V, dropout=0.1, device='cpu', **SMALL)


def test_dropout_is_keyword_only():
    """The positional arguments stay (n_token, n_layer, n_head, d_model,
    d_ff, d_embed, favor_dims, use_segment_emb, n_segment_types, use_pe,
    max_len); the dropout rate is passed by name."""
    from emo_disentanger_tpu_torch.models import MusicPerformer
    model = MusicPerformer(V, 2, 2, 32, 64, 32, 16, device='cpu')
    assert model.favor_dims == 16 and model.emb_dropout.p == 0.1
    with pytest.raises(TypeError):
        MusicPerformer(V, 2, 2, 32, 64, 32, 16, True, 2, True, 96, 0.1,
                       device='cpu')
