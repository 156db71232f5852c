"""ZeRO-style sharding placement — twin of
``paddle_tpu/distributed/fleet/sharding.py`` (reference:
fleet/meta_optimizers/sharding_optimizer.py:161,224,308 + sharding/
shard.py, prune.py).

The reference assigns parameters to shards, prunes each rank's program,
and inserts broadcast/allreduce ops.  The JAX package places
optimizer-state (and optionally parameter) arrays over the ``dp`` mesh
axis with a ``NamedSharding``; the port places them as
``distributed/mesh.py`` ``ShardedArray``s with the same specs: dim 0 split
over the axis where it divides, replicated where it does not.  Stage
mapping: stage 1 ≈ shard_opt_state; stage 3 ≈ shard_params.
"""
from __future__ import annotations

import numpy as np

from ..mesh import PartitionSpec, get_mesh, mesh_axis_size, shard_array, \
    tree_map


def _shard_spec_for(v, axis_name):
    """Shard dim 0 over axis_name when divisible; else replicate."""
    n = mesh_axis_size(axis_name)
    if v.ndim >= 1 and v.shape[0] % max(n, 1) == 0 and n > 1:
        return PartitionSpec(axis_name)
    return PartitionSpec()


def _place(v, axis_name, mesh):
    return shard_array(v, *_shard_spec_for(v, axis_name), mesh=mesh)


def shard_opt_state(opt_state, axis_name="dp"):
    """ZeRO-1: place every accumulator sharded over the data axis."""
    mesh = get_mesh()
    return tree_map(lambda v: _place(v, axis_name, mesh), opt_state)


def shard_params(params, axis_name="dp"):
    """ZeRO-3: parameters themselves sharded over the data axis."""
    mesh = get_mesh()
    return {n: _place(v, axis_name, mesh) for n, v in params.items()}


def assign_group_by_size(params, group_size_mb=32.0):
    """Reducer bucket assignment (reference reducer.cc:778
    AssignGroupBySize) — kept for API parity/testing."""
    groups, cur, cur_bytes = [], [], 0
    limit = group_size_mb * 1024 * 1024
    for name, v in params.items():
        itemsize = (v.element_size() if hasattr(v, "element_size")
                    else np.dtype(v.dtype).itemsize)
        nbytes = int(np.prod(v.shape)) * itemsize
        cur.append(name)
        cur_bytes += nbytes
        if cur_bytes >= limit:
            groups.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        groups.append(cur)
    return groups
