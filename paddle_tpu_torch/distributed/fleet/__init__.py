"""paddle_tpu_torch.distributed.fleet — twin of
``paddle_tpu/distributed/fleet`` (reference: python/paddle/distributed/fleet/).

The singleton `fleet` object is the module itself's API (reference
fleet/__init__.py re-exports the Fleet instance methods at module level).
"""
from . import meta_optimizers, recompute, sharding, trainer  # noqa: F401
from .dataset import (  # noqa: F401
    DatasetBase,
    DatasetFactory,
    InMemoryDataset,
    QueueDataset,
)
from .fleet_base import Fleet, fleet as _fleet_instance
from .trainer import (  # noqa: F401
    DeviceWorker,
    HogwildWorker,
    MultiTrainer,
    train_from_dataset,
)
from .role_maker import PaddleCloudRoleMaker, UserDefinedRoleMaker  # noqa: F401
from .strategy import DistributedStrategy  # noqa: F401
from .utils import HDFSClient, LocalFS  # noqa: F401

# module-level facade (paddle: fleet.init(...))
init = _fleet_instance.init
is_first_worker = _fleet_instance.is_first_worker
worker_index = _fleet_instance.worker_index
worker_num = _fleet_instance.worker_num
is_worker = _fleet_instance.is_worker
is_server = _fleet_instance.is_server
server_num = _fleet_instance.server_num
server_index = _fleet_instance.server_index
worker_endpoints = _fleet_instance.worker_endpoints
server_endpoints = _fleet_instance.server_endpoints
barrier_worker = _fleet_instance.barrier_worker
init_server = _fleet_instance.init_server
run_server = _fleet_instance.run_server
init_worker = _fleet_instance.init_worker
stop_worker = _fleet_instance.stop_worker
sparse_embedding = _fleet_instance.sparse_embedding
distributed_optimizer = _fleet_instance.distributed_optimizer
distributed_model = _fleet_instance.distributed_model
minimize = _fleet_instance.minimize
save_persistables = _fleet_instance.save_persistables
fleet = _fleet_instance
from . import metrics  # noqa: F401
from .dataset import MultiSlotDataGenerator  # noqa: F401
from .role_maker import Role  # noqa: F401
from .fleet_base import _UtilBase as UtilBase  # noqa: F401
