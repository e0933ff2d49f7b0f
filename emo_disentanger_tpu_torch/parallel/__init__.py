from .mesh import (
    dp_padded_batch_size, dp_size, make_mesh, mesh_for, pad_batch_to,
    shard_batch,
)
from .sharding_rules import placement_report, shard_params
