"""The port's mesh helpers and tensor-parallel placement on the CPU, in the
test process (the gloo legs are ``test_torch_parallel_train.py`` and
``test_torch_parallel_serve.py``):

* mesh shapes, the padded batch size and the row order of a sharded batch
  against JAX's ``make_mesh`` / ``batch_sharding`` on the virtual 8-device
  mesh; the refusals (a world that tp*dcn does not divide, a ``dcn`` that
  is not the node count, ``nccl`` with two ranks on one card, no group and
  no launcher, no named backend);
* ``placement_report`` of the Performer, GPT-2 and the Transformer-XL
  against JAX's report, rule by rule, at a vocabulary tp divides and one it
  does not; ``shard_params``'s refusals;
* a mesh of one rank trains exactly as ``mesh=None`` does, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from emo_disentanger_tpu.parallel import mesh as jmesh
from emo_disentanger_tpu.parallel.sharding_rules import (
    placement_report as jax_report)
from emo_disentanger_tpu_torch.parallel import mesh as tmesh
from emo_disentanger_tpu_torch.parallel.sharding_rules import (
    placement_report, shard_params)
from emo_disentanger_tpu_torch.train import trainer as ttr
from test_torch_txl import txl_pair
from torch_port_helpers import gpt2_pair, model_pair

SPEC = {P(None, 'tp'): 'col', P('tp', None): 'row', P(): 'replicated'}


class StubMesh:
    """A rank's view of a mesh of the grid ``tmesh.node_grid`` builds, for
    the row-order helpers (no process group)."""

    def __init__(self, grid, names, rank):
        self.mesh_dim_names = names
        self.mesh = torch.as_tensor(grid)
        self._coord = dict(zip(names, np.argwhere(grid == rank)[0]))

    def get_local_rank(self, name):
        return int(self._coord[name])


@pytest.mark.parametrize('tp,dcn', [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_mesh_shapes_padding_and_row_order_match_jax(tp, dcn):
    jm = jmesh.make_mesh(8, tp=tp, dcn=dcn)
    grid = tmesh.node_grid(8, tp, dcn)
    names = ('dp', 'tp') if dcn == 1 else ('dcn', 'dp', 'tp')
    assert grid.shape == jm.devices.shape
    shape = dict(zip(names, grid.shape))
    assert shape == dict(jm.shape)
    assert tmesh.dp_size(shape) == (8 // tp)
    for n in (1, 5, 8, 13):
        assert tmesh.dp_padded_batch_size(shape, n) == \
            jmesh.dp_padded_batch_size(jm, n)
    short = {'a': np.arange(15).reshape(5, 3), 'b': np.arange(5)}
    for k, v in tmesh.pad_batch_to(short, 8).items():
        np.testing.assert_array_equal(v, jmesh.pad_batch_to(short, 8)[k])

    # each device's rows under JAX's batch sharding are its rank's rows
    B = 16
    x = np.arange(B * 2).reshape(B, 2)
    placed = jax.device_put(x, jmesh.batch_sharding(jm))
    rows = {s.device.id: np.asarray(s.data)[:, 0] // 2
            for s in placed.addressable_shards}
    for pos in np.ndindex(grid.shape):
        rank = grid[pos]
        want = rows[jm.devices[pos].id]
        got = tmesh.shard_batch(StubMesh(grid, names, rank), {'x': x})['x']
        np.testing.assert_array_equal(got[:, 0] // 2, want)


def test_mesh_refusals(monkeypatch):
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(8, tp=3)
    with pytest.raises(ValueError) as terr:
        tmesh.node_grid(8, tp=3)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match='dcn=2 does not match the runtime '
                       'topology'):
        tmesh.node_grid(8, dcn=2, local_world=2)          # four nodes
    assert tmesh.node_grid(8, dcn=2, local_world=4).shape == (2, 4, 1)
    with pytest.raises(ValueError, match=r'not divisible by the mesh data '
                       r'axes \(dp\*dcn=4\)'):
        tmesh.local_rows({'dp': 4, 'tp': 1}, 6)

    assert not dist.is_initialized()
    for n in (None, 1):
        assert tmesh.mesh_for(n, backend=None, device='cpu') == (
            torch.device('cpu'), None)
    with pytest.raises(RuntimeError, match='n_devices=2 needs a process '
                       'group'):
        tmesh.mesh_for(2, backend='gloo', device='cpu')
    with pytest.raises(ValueError, match='name the backend'):
        tmesh.make_mesh(2, backend=None, device_type='cpu')
    # nccl on two ranks that share one card: refused before the group starts
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setenv('LOCAL_WORLD_SIZE', '2')
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match="backend 'nccl' needs one card a "
                       "rank: 2 ranks on this host share 1 CUDA device"):
        tmesh.make_mesh(backend='nccl', device_type='cuda')
    with pytest.raises(ValueError, match="backend 'nccl' runs on CUDA"):
        tmesh.make_mesh(backend='nccl', device_type='cpu')
    assert not dist.is_initialized()


def _name_map(jax_params, port_state):
    """JAX kernel path -> port weight name, by value (the weights are
    numpy draws, so each kernel matches one weight, as it is or
    transposed)."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    for path, leaf in flat:
        names = tuple(getattr(p, 'key', None) for p in path)
        if names[-1] != 'kernel':
            continue
        leaf = np.asarray(leaf)
        hits = [n for n, t in port_state.items() if t.dim() == 2 and (
            (t.shape == leaf.shape and np.array_equal(t.numpy(), leaf))
            or (t.shape == leaf.T.shape and np.array_equal(t.numpy(), leaf.T)))]
        assert len(hits) == 1, (names, hits)
        out['/'.join(names)] = hits[0]
    return out


def _family(name, V):
    """(JAX params, port model) with the same numpy-drawn weights."""
    if name == 'performer':
        _, jp, _, tm, _ = model_pair(V, seed=1)
        return jp, tm
    pair = gpt2_pair(V, seed=2) if name == 'gpt2' else txl_pair(V, seed=3)
    return pair[1], pair[2]


@pytest.mark.parametrize('V', [48, 47])
@pytest.mark.parametrize('family', ['performer', 'gpt2', 'txl'])
def test_placement_report_matches_jax_rule_by_rule(family, V):
    jp, model = _family(family, V)
    want = jax_report(jp, jmesh.make_mesh(8, tp=2))
    got = placement_report(model, {'dp': 4, 'tp': 2})
    assert sorted(got) == sorted(n for n, _ in model.named_parameters())
    names = _name_map(jp, model.state_dict())
    sharded = 0
    for jax_name, port_name in names.items():
        assert got[port_name] == SPEC[want[jax_name]], port_name
        sharded += got[port_name] != 'replicated'
        bias = port_name.replace('.weight', '.bias')
        if bias in got:
            assert got[bias] == (got[port_name] if got[port_name] == 'col'
                                 else 'replicated'), bias
    assert sharded >= 8
    head = 'col' if V % 2 == 0 else 'replicated'
    assert got['dec_out_proj.weight'] == head
    for name, role in got.items():
        if name not in names.values() and not name.endswith('.bias'):
            assert role == 'replicated', name
    assert set(placement_report(model, {'dp': 8, 'tp': 1}).values()) == \
        {'replicated'}


def test_shard_params_refusals():
    _, _, _, tm, _ = model_pair(48, seed=1)
    with pytest.raises(ValueError, match='n_head=2 does not split over tp=4'):
        shard_params(tm, {'dp': 2, 'tp': 4})
    # the Transformer-XL shards at tp=2 (tests/test_torch_parallel_txl.py);
    # heads that tp does not divide are refused as for the other families
    _, _, xtm = txl_pair(48, seed=3)
    with pytest.raises(ValueError, match='n_head=4 does not split over tp=8'):
        shard_params(xtm, {'dp': 1, 'tp': 8})
    assert shard_params(tm, {'dp': 2, 'tp': 1}) is tm       # tp=1: untouched


@pytest.fixture
def world_of_one():
    dist.init_process_group('gloo', store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield tmesh.make_mesh(1, backend='gloo', device_type='cpu')
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_trains_bitwise_as_no_mesh(world_of_one):
    """Two Adam steps (the clip active) and an eval step: a one-rank mesh
    runs the collectives on one rank, which change no bit."""
    mesh = world_of_one
    V, PAD = 23, 22
    rng = np.random.RandomState(4)
    batches = []
    for _ in range(2):
        tgt = rng.randint(0, V - 1, (3, 20))
        tgt[rng.rand(3, 20) < 0.3] = PAD
        batches.append(ttr.batch_to_device(
            {'dec_inp': rng.randint(0, V - 1, (3, 20)), 'dec_tgt': tgt,
             'track_mask': rng.randint(0, 2, (3, 20)),
             'chord_idx': rng.randint(0, 2, (3, 20)),
             'melody_idx': rng.randint(0, 2, (3, 20))}, 'cpu'))
    runs = []
    for m in (None, mesh):
        _, _, _, tm, tom = model_pair(V, seed=2)
        opt = ttr.make_optimizer(tm.parameters(), ttr.OptimizerConfig(
            max_lr=1e-3, warmup_steps=1, clip_norm=0.01))
        loss_fn = ttr.stage2_performer_loss_fn(tm, PAD)
        step = ttr.make_train_step(loss_fn, tm, opt, m)
        losses = [step(b, {'omegas': tom})[0] for b in batches]
        ev = ttr.make_eval_step(loss_fn, tm, m)(batches[0], {'omegas': tom})
        runs.append((losses, ev, dict(tm.named_parameters())))
    (l0, e0, p0), (l1, e1, p1) = runs
    assert [float(x) for x in l0] == [float(x) for x in l1]
    assert float(e0[0]) == float(e1[0])
    assert {k: float(v) for k, v in e0[1].items()} == \
        {k: float(v) for k, v in e1[1].items()}
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
