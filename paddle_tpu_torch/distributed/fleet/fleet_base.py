"""Fleet facade — twin of ``paddle_tpu/distributed/fleet/fleet_base.py``
(reference: fleet/base/fleet_base.py — init :130, distributed_optimizer
:598, distributed_model :649, minimize :1076).

The reference's meta-optimizer stack rewrites Programs; here each enabled
strategy wraps the training objects (see meta_optimizers.py), as in the
JAX package.  fleet.distributed_model / distributed_optimizer return the
wrapped objects.
"""
from __future__ import annotations

from typing import Optional

from ...optimizer.optimizer import Optimizer
from ..env import get_rank, get_world_size, init_parallel_env
from .meta_optimizers import apply_meta_optimizers
from .role_maker import PaddleCloudRoleMaker, RoleMakerBase
from .strategy import DistributedStrategy


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._is_initialized = False
        self._user_defined_optimizer = None

    def init(self, role_maker=None, is_collective=False, strategy=None):
        if role_maker is None:
            role_maker = PaddleCloudRoleMaker(is_collective=is_collective)
        self._role_maker = role_maker
        self._strategy = strategy or DistributedStrategy()
        init_parallel_env()
        self._is_initialized = True
        return self

    # --- identity ----------------------------------------------------------
    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def server_num(self):
        return self._role_maker.server_num()

    def server_index(self):
        return self._role_maker.server_index()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = self._role_maker.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        from ..collective import barrier

        barrier()

    # --- parameter-server runtime (reference fleet/runtime/the_one_ps.py:400
    # driving the brpc PSServer/PSClient; ps/runtime.py: in-process tables,
    # or PSServer processes behind a PSClient) ------------------------------
    def init_server(self, *args, **kwargs):
        from ..ps import runtime

        runtime.init_server()

    def run_server(self):
        from ..ps import runtime

        runtime.run_server()

    def init_worker(self):
        from ..ps import runtime

        runtime.init_worker(self._strategy)

    def stop_worker(self):
        from ..ps import runtime

        runtime.stop_worker()

    def sparse_embedding(self, name: str, dim: int, rule: str = None,
                         lr: float = None, **table_kw):
        """Create (or fetch) a PS-backed sparse embedding whose merge policy
        follows the strategy's a_sync / a_sync_configs.k_steps flags
        (distributed_strategy.proto:108-118: sync / async / geo)."""
        from ..ps import runtime

        return runtime.sparse_embedding(name, dim, rule=rule, lr=lr,
                                        strategy=self._strategy, **table_kw)

    # --- training objects --------------------------------------------------
    def distributed_optimizer(self, optimizer: Optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        self._user_defined_optimizer = optimizer
        return apply_meta_optimizers(self, optimizer, self._strategy)

    def distributed_model(self, model):
        from ..parallel import DataParallel

        if get_world_size() > 1:
            return DataParallel(model)
        return model

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        opt = self._user_defined_optimizer
        return opt.minimize(loss)

    # --- checkpoint --------------------------------------------------------
    def save_persistables(self, executor=None, dirname=None, main_program=None,
                          mode=0):
        from ...framework_io import save

        if hasattr(executor, "state_dict"):
            save(executor.state_dict(), dirname)

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        """reference fleet_base.py:518 — export the inference slice of the
        (static) program: feeds named by `feeded_var_names`, outputs
        `target_vars`, params baked (serves via inference.Predictor)."""
        from ...static import default_main_program

        program = main_program or default_main_program()
        names = set(feeded_var_names or [])
        missing = names - {v.name for v in program.feed_vars}
        if missing:
            raise ValueError(
                f"save_inference_model: feeds {sorted(missing)} are not "
                "declared by the program")
        program.save(dirname, list(target_vars))
        return dirname

    @property
    def util(self):
        return _UtilBase()


class _UtilBase:
    def all_reduce(self, input, mode="sum"):
        """reference UtilBase.all_reduce (CPU-side, over Gloo): reduce a
        host value across trainer processes.  World of one -> identity;
        multi-process goes through the gloo backend (raises if absent —
        a silent identity would skip synchronization, r4 collective
        rule)."""
        import numpy as np

        from .. import gloo
        from ..env import get_world_size

        if get_world_size() <= 1:
            return input
        be = gloo.get_backend()
        if be is None:
            raise RuntimeError(
                "fleet.util.all_reduce with PADDLE_TRAINERS_NUM > 1 needs "
                "the gloo backend (init_parallel_env with "
                "PADDLE_GLOO_ENDPOINT)")
        arr = np.asarray(input)
        out = be.all_reduce(arr, {"sum": "sum", "min": "min",
                                  "max": "max"}[mode])
        return out if arr.ndim else type(input)(out)

    def barrier(self):
        from ..collective import barrier

        barrier()

    def get_file_shard(self, files):
        n = get_world_size()
        r = get_rank()
        return files[r::n]


fleet = Fleet()
