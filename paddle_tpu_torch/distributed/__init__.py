"""paddle_tpu_torch.distributed — twin of ``paddle_tpu/distributed``:
collectives, meshes and parallel training on one process's device mesh
(``mesh.py``: the slots, ``shard_map`` and the list collectives of the
serving mesh; ``lax.py``: the collectives of a ``shard_map`` body), with
the eager host backend (``gloo.py``) between trainer processes.

``fleet`` (the facade, the strategy stack, the datasets and the
dataset trainer) and ``ps`` (the sparse table, its communicator, the
PS service and the device cache) are the parameter-server and fleet
halves.
"""
from . import fleet, launch, ps  # noqa: F401
from .collective import (  # noqa: F401
    Group,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    alltoall,
    barrier,
    broadcast,
    get_group,
    is_initialized,
    new_group,
    p2p_shift,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    split,
    wait,
)
from .entry import CountFilterEntry, ProbabilityEntry  # noqa: F401
from .env import (ParallelEnv, device_count, get_rank,  # noqa: F401
                  get_world_size, init_parallel_env)
from .mesh import (Mesh, NamedSharding, PartitionSpec,  # noqa: F401
                   ShardedArray, devices, force_device_count, get_mesh,
                   init_mesh, mesh_axis_size, pmax, psum,
                   replicated_sharding, set_mesh, shard_array, shard_map,
                   sharding, spec)
from .parallel import (DataParallel, make_localsgd_train_step,  # noqa: F401
                       make_sharded_train_step, sync_params_buffers)
from .parallel_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from .pipeline import (build_1f1b_schedule, pipeline_apply,  # noqa: F401
                       pipeline_forward, pipeline_train_1f1b,
                       pipeline_train_step, schedule_peak_in_flight,
                       stack_stage_params)
from .ring_attention import (  # noqa: F401
    ring_attention,
    sequence_parallel_attention,
    ulysses_attention,
)
from .spawn import spawn  # noqa: F401
