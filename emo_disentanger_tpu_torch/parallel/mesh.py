"""Device mesh over ``torch.distributed`` ranks (port of
``emo_disentanger_tpu/parallel/mesh.py``).

A rank is one process with one device.  :func:`make_mesh` arranges the
world's ranks as a ``torch.distributed.device_mesh.DeviceMesh`` with dims
``('dp', 'tp')``, or ``('dcn', 'dp', 'tp')`` with ``dcn > 1``:

* ``dp``: the batch is split over it; parameters are replicated and the
  gradients are summed over it (``train.trainer``);
* ``tp``: tensor parallelism; ``sharding_rules.shard_params`` splits the
  widest matrices over it;
* ``dcn``: nodes.  Where JAX groups devices by TPU slice, the port groups
  ranks by node (``LOCAL_WORLD_SIZE`` ranks a node, as ``torchrun`` sets
  it), so that the inner ``('dp', 'tp')`` dims never straddle nodes.  When
  every rank is on one host (the CPU tests) a plain reshape emulates the
  grouping, as JAX does for CPU meshes.

JAX places arrays with ``NamedSharding``; torch has no such object, so
``batch_sharding`` and ``replicated_sharding`` have no counterpart here.
What takes their place: :func:`shard_batch` hands each rank its rows of a
batch (batch sharding), and a parameter is replicated by building it from
the same seed on every rank (checked by :func:`check_replicas`).  The data
axes ``('dcn', 'dp')`` flattened are one process group,
:func:`data_group`; collectives over it are :func:`all_reduce_data` and
:func:`all_gather_data` (host values).

With no process group and ``n_devices`` of None or 1, the entry points
take the single-device path and build no mesh (:func:`mesh_for`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

MeshLike = Union['torch.distributed.device_mesh.DeviceMesh', Dict[str, int]]


def node_grid(world: int, tp: int = 1, dcn: int = 1,
              local_world: Optional[int] = None) -> np.ndarray:
    """The ranks ``arange(world)`` arranged as [dp, tp], or [dcn, dp, tp]
    with ``dcn > 1``.  ``local_world`` is the ranks a node holds
    (``LOCAL_WORLD_SIZE``; None or ``world``: one host, emulated).  Raises
    where JAX's ``make_mesh`` raises."""
    if world % (tp * dcn):
        raise ValueError(
            f'n_devices={world} not divisible by tp*dcn={tp * dcn}')
    dp = world // (tp * dcn)
    ranks = np.arange(world)
    if dcn == 1:
        return ranks.reshape(dp, tp)
    if local_world is not None and local_world < world:
        # launchers number ranks node-major, so a node's ranks are a
        # contiguous block: the dcn axis must be the node axis
        n_nodes = world // local_world
        if world % local_world or n_nodes != dcn:
            raise ValueError(
                f'dcn={dcn} does not match the runtime topology '
                f'({world} ranks, {local_world} a node)')
    return ranks.reshape(dcn, dp, tp)


def _local_world(world: int) -> int:
    return int(os.environ.get('LOCAL_WORLD_SIZE', world))


def _check_backend_devices(backend: str, device_type: str, world: int) -> None:
    """NCCL needs a card of its own for every rank of a host."""
    if backend != 'nccl':
        return
    if device_type != 'cuda':
        raise ValueError(f"backend 'nccl' runs on CUDA devices, not "
                         f"{device_type!r}")
    local = _local_world(world)
    cards = torch.cuda.device_count()
    if local > cards:
        raise ValueError(
            f"backend 'nccl' needs one card a rank: {local} ranks on this "
            f"host share {cards} CUDA device(s); ranks that share a card "
            f"take 'gloo'")


def init_world(backend: Optional[str], n_devices: Optional[int] = None,
               device_type: str = 'cuda') -> str:
    """Take the default process group the caller made, or make it from the
    launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT``), or, with neither and ``n_devices`` of None or 1, a
    world of one.  Returns the group's backend; a named ``backend`` must
    be it.  The backend is never guessed."""
    if dist.is_initialized():
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f'backend {backend!r} named, but the process '
                             f'group runs {have!r}')
        _check_backend_devices(have, device_type, dist.get_world_size())
        return have
    if backend is None:
        raise ValueError("name the backend ('nccl' or 'gloo') to start "
                         "the process group")
    if 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
        _check_backend_devices(backend, device_type,
                               int(os.environ['WORLD_SIZE']))
        dist.init_process_group(backend)
    elif n_devices in (None, 1):
        _check_backend_devices(backend, device_type, 1)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        raise RuntimeError(
            f'n_devices={n_devices} needs a process group of that size: '
            f'start the ranks with torchrun (RANK, WORLD_SIZE in the '
            f'environment) or call init_process_group first')
    return backend


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, dcn: int = 1, *,
              backend: Optional[str] = None, device_type: str = 'cuda'):
    """The world's ranks as a ``DeviceMesh`` with dims ('dp', 'tp'), or
    ('dcn', 'dp', 'tp') when ``dcn > 1`` (module docstring).
    ``n_devices=None`` means the world size; any other value must be it.
    On CUDA, the caller sets each rank's device first
    (``torch.cuda.set_device``)."""
    from torch.distributed.device_mesh import DeviceMesh
    init_world(backend, n_devices, device_type)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f'n_devices={n_devices} but the process group has '
                         f'{world} ranks')
    grid = node_grid(world, tp, dcn, _local_world(world))
    names = ('dp', 'tp') if dcn == 1 else ('dcn', 'dp', 'tp')
    mesh = DeviceMesh(device_type, torch.as_tensor(grid), mesh_dim_names=names)
    # the flattened data axes: one group a tp index, made by every rank in
    # the same order
    data = None
    flat = grid.reshape(-1, tp)
    for t in range(tp):
        members = flat[:, t].tolist()
        group = (mesh.get_group('dp') if dcn == 1
                 else dist.new_group(members))
        if dist.get_rank() in members:
            data = group
    mesh.emodis_data_group = data
    return mesh


def mesh_for(n_devices: Optional[int], *, backend: Optional[str], device
             ) -> Tuple[torch.device, Optional['DeviceMesh']]:
    """(device, mesh) an entry point runs on.  The mesh is None, today's
    single-device path, with no process group, no launcher environment and
    ``n_devices`` of None or 1.  Under a mesh a bare ``'cuda'`` means
    ``cuda:LOCAL_RANK`` and becomes the current device; an explicit index
    (ranks that share one card pass ``cuda:0``) is kept."""
    dev = torch.device(device)
    launched = int(os.environ.get('WORLD_SIZE', '1')) > 1
    if n_devices in (None, 1) and not dist.is_initialized() and not launched:
        return resolve_device(dev), None
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    dev = resolve_device(dev)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    return dev, make_mesh(n_devices, backend=backend, device_type=dev.type)


# ---------------------------------------------------------------- queries

def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """{dim name: size}; a dict is taken as the shape itself (the pure
    helpers below run on it without a process group)."""
    if mesh is None:
        return {'dp': 1, 'tp': 1}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_size(mesh: MeshLike) -> int:
    """Ranks along the data axes: dp * dcn."""
    shape = mesh_shape(mesh)
    return shape.get('dp', 1) * shape.get('dcn', 1)


def tp_size(mesh: MeshLike) -> int:
    return mesh_shape(mesh).get('tp', 1)


def data_rank(mesh) -> int:
    """This rank's index along the flattened data axes, rank-major over
    ('dcn', 'dp') as JAX's batch sharding lays rows out."""
    if mesh is None:
        return 0
    shape = mesh_shape(mesh)
    i = mesh.get_local_rank('dp')
    if 'dcn' in shape:
        i += mesh.get_local_rank('dcn') * shape['dp']
    return i


def tp_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank('tp')


def data_group(mesh):
    return mesh.emodis_data_group


def tp_group(mesh):
    return mesh.get_group('tp')


def dp_padded_batch_size(mesh: MeshLike, batch_size: int) -> int:
    """Smallest batch size >= ``batch_size`` divisible by the data axes
    (dp * dcn).  Drivers pad short batches with PAD-target rows up to it."""
    dp = dp_size(mesh)
    return -(-batch_size // dp) * dp


def pad_batch_to(batch: dict, batch_size: int) -> dict:
    """Pad a possibly-short final batch up to ``batch_size`` by repeating the
    last row (keeps shapes static; metrics weight by true size)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.ndim >= 1 and v.shape[0] < batch_size:
            reps = np.repeat(v[-1:], batch_size - v.shape[0], axis=0)
            v = np.concatenate([v, reps], axis=0)
        out[k] = v
    return out


def local_rows(mesh, batch_size: int) -> slice:
    """This rank's rows of a [batch_size, ...] array: the ``data_rank``-th
    of ``dp_size`` equal blocks; the same rows for every tp rank."""
    n = dp_size(mesh)
    if batch_size % n:
        raise ValueError(f'batch={batch_size} not divisible by the mesh data '
                         f'axes (dp*dcn={n})')
    per = batch_size // n
    r = data_rank(mesh)
    return slice(r * per, (r + 1) * per)


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's rows of each B-leading array (numpy or torch) of
    ``batch``; other entries pass through.  On no mesh, or a mesh of one,
    the batch itself."""
    if mesh is None or dp_size(mesh) == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if getattr(v, 'ndim', 0) >= 1:
            v = v[local_rows(mesh, v.shape[0])]
        out[k] = v
    return out


# ---------------------------------------------------------- collectives

def _comm_device(group) -> torch.device:
    """Where a host value travels for a collective: the current CUDA
    device under NCCL, the CPU otherwise."""
    if dist.get_backend(group) == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def all_reduce_data(mesh, values: Sequence[float], op: str = 'sum',
                    dtype=torch.float64) -> List[float]:
    """Reduce host numbers over the data axes ('sum' or 'max'); each rank
    gets the result."""
    group = data_group(mesh)
    t = torch.tensor(list(values), dtype=dtype, device=_comm_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == 'sum' else
                    dist.ReduceOp.MAX, group=group)
    return t.cpu().tolist()


def all_gather_data(mesh, array: np.ndarray) -> np.ndarray:
    """Concatenate every data rank's ``array`` (same shape on each) along
    axis 0, in data-rank order.  Built on ``all_reduce`` into a zeroed
    buffer, which every backend supports on every device."""
    group = data_group(mesh)
    n, r = dp_size(mesh), data_rank(mesh)
    a = np.asarray(array)
    wide = torch.float64 if a.dtype.kind == 'f' else torch.int64
    buf = torch.zeros((n,) + a.shape, dtype=wide, device=_comm_device(group))
    buf[r] = torch.as_tensor(a).to(buf)
    dist.all_reduce(buf, group=group)
    return buf.cpu().numpy().reshape((n * a.shape[0],) + a.shape[1:]) \
        .astype(a.dtype)


def check_replicas(model: torch.nn.Module, mesh) -> None:
    """Raise unless every data rank holds the same parameters: each
    parameter's float64 sum and sum of squares, compared by max and min
    over the data axes.  Tensor-parallel shards are compared only between
    ranks of the same tp index, which share a data group."""
    if mesh is None or dp_size(mesh) == 1:
        return
    sums = []
    for p in model.parameters():
        d = p.detach().double()
        sums += [float(d.sum()), float((d * d).sum())]
    hi = all_reduce_data(mesh, sums, 'max')
    lo = [-x for x in all_reduce_data(mesh, [-x for x in sums], 'max')]
    names = [n for n, _ in model.named_parameters() for _ in range(2)]
    bad = sorted({names[i] for i in range(len(sums)) if hi[i] != lo[i]})
    if bad:
        raise RuntimeError(f'parameters differ between data ranks: {bad[:5]}')


def batch_rows(mesh, batch: int) -> Tuple[Optional['DeviceMesh'], slice]:
    """(mesh, rows) of a batched generator of ``batch`` slots: the mesh it
    splits them over (None when the data axes are one) and this rank's
    rows of them."""
    if mesh is None or dp_size(mesh) == 1:
        return None, slice(0, batch)
    return mesh, local_rows(mesh, batch)


def any_rows(mesh, flag: torch.Tensor) -> bool:
    """``flag.any()`` over every data rank's rows."""
    return bool(reduce_flags(mesh, [int(flag.any())])[0])


def reduce_flags(mesh, values: Sequence[int], op: str = 'max') -> List[int]:
    """Integers read on the host, reduced over the data axes by ``op``
    ('max': an ``any`` for flags; 'sum'); themselves without a mesh."""
    if mesh is None:
        return [int(v) for v in values]
    return [int(v) for v in all_reduce_data(mesh, values, op,
                                            dtype=torch.int64)]


def gather_rows(mesh, t: torch.Tensor) -> np.ndarray:
    """A [B_local, ...] tensor as the host array of every data rank's rows
    [B, ...], in row order; its own host copy without a mesh."""
    a = t.cpu().numpy()
    return a if mesh is None else all_gather_data(mesh, a)
