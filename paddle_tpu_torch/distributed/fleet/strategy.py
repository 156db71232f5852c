"""DistributedStrategy — twin of ``paddle_tpu/distributed/fleet/strategy.py``
(reference: fleet/base/distributed_strategy.py:104 over
distributed_strategy.proto — the full distributed feature matrix).

The same property surface.  The knobs the JAX package acts on:
``gradient_merge``, ``localsgd``, ``dgc`` (``rampup_begin_step`` and the
first ``sparsity``), ``fp16_allreduce``, ``lars`` / ``lamb`` (their
coefficients), ``recompute`` (a marker), ``sharding`` and ``a_sync``
with ``a_sync_configs.k_steps``.  It stores every other knob and reads
none of them (``UNREAD``); the port refuses each one set away from its
default where the strategy is acted on (:func:`refuse_unread`, called by
``fleet.distributed_optimizer`` and ``fleet.sparse_embedding``).
"""
from __future__ import annotations

from typing import Any, Dict, List

from ...framework.errors import InvalidArgumentError


class _Config(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        # feature switches (proto:126-169)
        self.amp = False
        self.amp_configs = _Config(
            init_loss_scaling=32768.0, incr_every_n_steps=1000,
            decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5,
            use_dynamic_loss_scaling=True, custom_white_list=[],
            custom_black_list=[], use_pure_fp16=False, use_bf16=True)
        self.recompute = False
        self.recompute_configs = _Config(checkpoints=[], enable_offload=False,
                                         checkpoint_shape=[])
        self.pipeline = False
        self.pipeline_configs = _Config(micro_batch_size=1, accumulate_steps=1,
                                        schedule_mode="1F1B")
        self.gradient_merge = False
        self.gradient_merge_configs = _Config(k_steps=1, avg=True)
        self.sharding = False
        self.sharding_configs = _Config(sharding_degree=1, mp_degree=1,
                                        hybrid_dp=False, fuse_broadcast_MB=32.0)
        self.localsgd = False
        self.localsgd_configs = _Config(k_steps=1, begin_step=1)
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = _Config(init_k_steps=1, begin_step=1)
        self.dgc = False
        self.dgc_configs = _Config(rampup_begin_step=0, rampup_step=1,
                                   sparsity=[0.999])
        self.lars = False
        self.lars_configs = _Config(lars_coeff=0.001, lars_weight_decay=0.0005,
                                    epsilon=0, exclude_from_weight_decay=[])
        self.lamb = False
        self.lamb_configs = _Config(lamb_weight_decay=0.01,
                                    exclude_from_weight_decay=[])
        self.fp16_allreduce = False
        self.a_sync = False
        self.a_sync_configs = _Config(k_steps=0, max_merge_var_num=1,
                                      send_queue_size=16,
                                      independent_recv_thread=False,
                                      thread_pool_size=1, send_wait_times=1,
                                      runtime_split_send_recv=False)
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Config(tensor_parallel_degree=1,
                                               tensor_init_seed=-1)
        self.elastic = False
        self.auto = False
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 1
        self.sync_nccl_allreduce = True
        self.fuse_grad_size_in_MB = 32
        self.fuse_all_reduce_ops = True
        self.sync_batch_norm = False
        self.without_graph_optimization = False
        # execution/build strategy stand-ins (proto:84,99)
        self.execution_strategy = _Config(num_threads=1, num_iteration_per_drop_scope=10)
        self.build_strategy = _Config(enable_sequential_execution=False)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()}

    def __repr__(self):
        on = [k for k, v in self.__dict__.items() if v is True]
        return f"DistributedStrategy(enabled={on})"


# the knobs the JAX package stores and never reads: a whole attribute, or
# (attribute, config keys)
UNREAD = (
    "amp", "amp_configs", "recompute_configs", "pipeline",
    "pipeline_configs", "sharding_configs", "adaptive_localsgd",
    "adaptive_localsgd_configs", ("dgc_configs", ("rampup_step",)),
    ("lars_configs", ("exclude_from_weight_decay",)),
    ("lamb_configs", ("exclude_from_weight_decay",)),
    ("a_sync_configs", ("max_merge_var_num", "send_queue_size",
                        "independent_recv_thread", "thread_pool_size",
                        "send_wait_times", "runtime_split_send_recv")),
    "tensor_parallel", "tensor_parallel_configs", "elastic", "auto",
    "nccl_comm_num", "use_hierarchical_allreduce",
    "hierarchical_allreduce_inter_nranks", "sync_nccl_allreduce",
    "fuse_grad_size_in_MB", "fuse_all_reduce_ops", "sync_batch_norm",
    "without_graph_optimization", "execution_strategy", "build_strategy",
)


def unread_set(strategy) -> List[str]:
    """The unread knobs of ``strategy`` set away from their defaults (a
    ``dgc_configs.sparsity`` schedule longer than one value counts: only
    its first value is read)."""
    default = DistributedStrategy()
    out = []
    for knob in UNREAD:
        name, keys = (knob, None) if isinstance(knob, str) else knob
        cur, ref = getattr(strategy, name), getattr(default, name)
        if isinstance(ref, dict):
            keys = keys or sorted(set(cur) | set(ref))
            out += [f"{name}.{k}" for k in keys if cur.get(k) != ref.get(k)]
        elif cur != ref:
            out.append(name)
    if len(strategy.dgc_configs.get("sparsity", [])) > 1:
        out.append("dgc_configs.sparsity[1:]")
    return out


def refuse_unread(strategy) -> None:
    """Raise ``InvalidArgumentError`` naming every unread knob that is set
    away from its default (ROADMAP queue 3, "Unported knobs raise")."""
    if strategy is None:
        return
    bad = unread_set(strategy)
    if bad:
        raise InvalidArgumentError(
            f"DistributedStrategy knob(s) {bad} are not supported: the JAX "
            "package stores them and never reads them (ROADMAP \"Known "
            "facts about the reference\")")
