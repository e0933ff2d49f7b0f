"""The stage-1 Transformer-XL under tensor parallelism, on the CPU with
four gloo ranks (``torch_parallel_ranks``) as a dp=2 x tp=2 mesh, against
the port's one-process run and the JAX package (dropout 0, f32).

* The forward over two segments, the second on the first's XL memories:
  logits and memories equal the port's tp=1 forward and JAX's
  ``shard_params`` forward on the (dp=4, tp=2) virtual mesh within JAX's
  tolerance (``tests/test_tp_sharding.py:78,94``).  Each rank holds half
  the heads.
* Three Adam steps, the clip active on every step: the losses, the
  parameters gathered from each data group's tp ranks and the first
  step's reduced gradients track one process and JAX's dp-only run within
  ``tests/test_tp_sharding.py:140``'s tolerance.  The gradient of the
  replicated r_w / r_r biases, whose heads each rank slices, is whole and
  equal on every rank.
* Two segmented steps (memories carried, a row all PAD): losses, each
  rank's memories and the gathered parameters track one process.
* The refusals: heads that tp does not divide, and decoding under tp.
"""

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
from emo_disentanger_tpu_torch.convert import flax_txl_to_torch
from emo_disentanger_tpu_torch.parallel import shard_params
from test_torch_parallel_train import (
    CFG, FWD_TOL, PAD, TRAIN_TOL, V, _assert_tracks, _gathered, _segments)
from test_torch_txl import TXL_SMALL, txl_pair


def _batches():
    """Three stage-1 batches of 8 rows, 16 tokens; the last two rows all
    PAD, so the data ranks' counts differ."""
    rng = np.random.RandomState(11)
    out = []
    for _ in range(3):
        tgt = rng.randint(0, V - 1, (8, 16))
        tgt[rng.rand(8, 16) < 0.3] = PAD
        tgt[6:] = PAD
        out.append({'dec_inp': rng.randint(0, V - 1, (8, 16)), 'dec_tgt': tgt,
                    'inp_chord': (rng.rand(8, 16) < 0.3).astype(np.int64),
                    'inp_melody': (rng.rand(8, 16) < 0.3).astype(np.int64)})
    return out


def _jax_dp_run(jm, jp, batches):
    """JAX's three Adam steps on the dp=8 mesh: (losses, parameters by the
    port's names), and the gradient of the first batch's loss."""
    opt = jtr.make_optimizer(jtr.OptimizerConfig(**CFG))
    mesh = jax_mesh(8)
    loss_fn = jtr.stage1_loss_fn(jm, PAD)
    step = jtr.make_train_step(loss_fn, opt, mesh, donate=False)
    jb = [{k: jnp.asarray(v, jnp.int32) for k, v in b.items()} for b in batches]
    grads = jax.grad(lambda p: loss_fn(p, jb[0], None, {})[0])(jp)
    state = jtr.init_train_state(jp, opt)
    losses = []
    for b in jb:
        state, loss, _ = step(state, jax_shard_batch(mesh, b), None, {})
        losses.append(float(loss))
    to_port = lambda p: flax_txl_to_torch(  # noqa: E731
        jax.tree.map(np.asarray, p), TXL_SMALL['n_layer'])
    return (losses, to_port(state.params)), to_port(grads)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    torch.set_num_threads(1)
    jm, jp, tm = txl_pair(V, seed=12)
    jmm, jpm, tmm = txl_pair(V, seed=13, mem_len=8)
    rng = np.random.RandomState(12)
    tokens = [torch.from_numpy(rng.randint(0, V - 1, (2, 12))).long()
              for _ in range(2)]
    batches = _batches()
    segmented = (tm.state_dict(), TXL_SMALL, _segments(), CFG, PAD)
    got = R.spawn('leg_txl_tp', 4, tmp_path_factory.mktemp('txl_tp'),
                  tm.state_dict(), TXL_SMALL, tmm.state_dict(), tokens,
                  batches, CFG, PAD, segmented)
    return dict(got=got, jax=(jm, jp), jax_mem=(jmm, jpm), model=tm,
                mem_model=tmm, tokens=tokens, batches=batches,
                segmented=segmented)


def test_txl_tp_forward_over_two_segments(ranks):
    tmm, tokens = ranks['mem_model'], ranks['tokens']
    with torch.no_grad():
        first, mems = tmm(tokens[0])
        second, mems = tmm(tokens[1], mems)
    want = (first, second, torch.stack(mems))
    jm, jp = ranks['jax_mem']
    sharded = jax_shard_params(jp, jax_mesh(8, tp=2))
    jfirst, jmems = jm.apply(sharded, jnp.asarray(tokens[0].numpy()))
    jsecond, jmems = jm.apply(sharded, jnp.asarray(tokens[1].numpy()), jmems)
    jwant = (jfirst, jsecond, jnp.stack(jmems))
    for r, rank in enumerate(ranks['got']):
        assert rank['heads'] == 3 * TXL_SMALL['d_model'] // 2   # half the heads
        for name, got, w, jw in zip(('segment 1', 'segment 2', 'memories'),
                                    rank['forward'], want, jwant):
            np.testing.assert_allclose(got.numpy(), w.numpy(),
                                       err_msg=f'{name} rank {r}', **FWD_TOL)
            np.testing.assert_allclose(got.numpy(), np.asarray(jw),
                                       err_msg=f'{name} rank {r} vs JAX',
                                       **FWD_TOL)


def test_txl_dp_tp_training_tracks_one_process_and_jax(ranks):
    model, batches = ranks['model'], ranks['batches']
    one = R.stage1_steps(R.txl(model.state_dict(), TXL_SMALL), batches, CFG,
                         PAD)
    jm, jp = ranks['jax']
    jrun, jgrads = _jax_dp_run(jm, jp, batches)
    _assert_tracks(one[:2], jrun, 'one process vs JAX dp=8')
    # the clip acts on the first step (and so on all three)
    norm = torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in one[2].values()]))
    assert float(norm) > 5 * CFG['clip_norm']
    got = ranks['got']
    for dp in range(2):
        params = _gathered([r['train'][:2] for r in got], model, 2, dp)
        _assert_tracks(params, one[:2], f'dp2xtp2 group {dp}')
        _assert_tracks(params, jrun, f'dp2xtp2 group {dp} vs JAX')
        grads = _gathered([(r['train'][0], r['train'][2]) for r in got],
                          model, 2, dp)[1]
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), one[2][name].numpy(),
                                       err_msg=f'gradient {name}', **TRAIN_TOL)
    for r, rank in enumerate(got):
        for name in ('decoder.r_w_bias', 'decoder.r_r_bias'):
            g = rank['train'][2][name]
            assert g.shape == (TXL_SMALL['n_head'], TXL_SMALL['d_model']
                               // TXL_SMALL['n_head'])
            np.testing.assert_allclose(g.numpy(), one[2][name].numpy(),
                                       err_msg=f'{name} rank {r}', **TRAIN_TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]),
                                       err_msg=f'{name} rank {r} vs JAX',
                                       **TRAIN_TOL)


def test_txl_dp_tp_segmented_steps_track_one_process(ranks):
    one = R.segmented_steps(*ranks['segmented'])
    got = ranks['got']
    for dp in range(2):
        losses, params = _gathered(
            [(r['segmented'][0], r['segmented'][2]) for r in got],
            ranks['model'], 2, dp)
        _assert_tracks((losses, params), (one[0], one[2]),
                       f'segmented group {dp}')
    for r, rank in enumerate(got):
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)     # its data group's rows
        np.testing.assert_allclose(rank['segmented'][1].numpy(),
                                   one[1][:, rows].numpy(),
                                   err_msg=f'memories rank {r}', **TRAIN_TOL)


def test_txl_tp_refusals(ranks):
    for rank in ranks['got']:
        assert 'does not decode' in rank['decode']
    _, _, tm = txl_pair(V, seed=3)
    with pytest.raises(ValueError, match='n_head=4 does not split over tp=8'):
        shard_params(tm, {'dp': 1, 'tp': 8})
