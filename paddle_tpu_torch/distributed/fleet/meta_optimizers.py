"""Meta-optimizers — the strategy stack; twin of
``paddle_tpu/distributed/fleet/meta_optimizers.py``.

Reference analog: fleet/meta_optimizers/*.py (factory
meta_optimizer_factory.py:15-30; strategy_compiler.py): program-rewriting
passes for AMP, recompute, gradient-merge, LARS/LAMB, localsgd, DGC,
fp16-allreduce, sharding, pipeline.

As in the JAX package, each enabled strategy wraps the optimizer's eager
step (and, for sharding, its functional ``init_opt_state``) instead of
rewriting a Program.  The composition order follows the reference's
strategy compiler: {lars|lamb} → dgc → fp16_allreduce → gradient_merge →
localsgd → recompute → sharding.  The reference's quirks are kept:
gradient merge keys its sums by ``id`` of the parameter, clears the
gradients on the steps between boundaries and divides by ``k_steps``
when ``avg`` is set; DGC keeps every entry at or above the k-th
magnitude, ties included; the "fp16" all-reduce rounds through
**bfloat16**.  DGC's sparsify pass stays on the device: the threshold is
a tensor, no value is read back, so a step does not sync the host.
"""
from __future__ import annotations

import torch

from ...optimizer.optimizer import Lamb, Lars, Optimizer
from .strategy import refuse_unread


class MetaOptimizerBase(Optimizer):
    def __init__(self, inner: Optimizer):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self):
        self.inner.step()

    def clear_grad(self, set_to_zero=True):
        self.inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        return self.inner.minimize(loss, *a, **k)

    def state_dict(self):
        return self.inner.state_dict()

    def set_state_dict(self, d):
        return self.inner.set_state_dict(d)

    def get_lr(self):
        return self.inner.get_lr()

    def init_opt_state(self, params):
        return self.inner.init_opt_state(params)

    def fused_step(self, params, grads, opt_state, step, lr=None, **kw):
        return self.inner.fused_step(params, grads, opt_state, step, lr=lr,
                                     **kw)


class GradientMergeOptimizer(MetaOptimizerBase):
    """k-step gradient accumulation (reference gradient_merge_optimizer.py)."""

    def __init__(self, inner, k_steps=1, avg=True):
        super().__init__(inner)
        self.k_steps = k_steps
        self.avg = avg
        self._acc = {}
        self._count = 0

    def step(self):
        self._count += 1
        params = self.inner._param_list()
        for p in params:
            if p.grad is None:
                continue
            key = id(p)
            self._acc[key] = (p.grad if key not in self._acc
                              else self._acc[key] + p.grad)
        if self._count % self.k_steps != 0:
            for p in params:
                p.grad = None
            return
        for p in params:
            key = id(p)
            if key in self._acc:
                g = self._acc[key]
                if self.avg:
                    g = g / self.k_steps
                p.grad = g
        self._acc.clear()
        self.inner.step()


class LocalSGDOptimizer(MetaOptimizerBase):
    """LocalSGD: k local steps per replica, then parameters are AVERAGED
    across replicas (reference localsgd_optimizer.py — the opposite of
    per-step gradient allreduce).

    ``step()`` runs the inner update and, every ``k_steps`` past
    ``begin_step``, averages every parameter over the default group: the
    mesh axis inside a ``shard_map`` body, the trainer processes over the
    gloo backend eagerly (which raises when several trainers have none),
    nothing in a world of one.  The SPMD path is
    ``distributed.parallel.make_localsgd_train_step``."""

    def __init__(self, inner, k_steps=1, begin_step=1):
        super().__init__(inner)
        self.k_steps = k_steps
        self.begin_step = begin_step
        self._count = 0

    def step(self):
        self.inner.step()
        self._count += 1
        if self._count >= self.begin_step and \
                self._count % self.k_steps == 0:
            self.sync_params()

    def sync_params(self):
        """Average parameters across the group (localsgd_optimizer.py
        snapshot/allreduce/scale sequence); returns whether any
        averaging ran."""
        from .. import collective
        from ..env import get_world_size
        from ..mesh import in_shard_map
        from ...tensor import Tensor

        if not in_shard_map() and get_world_size() <= 1:
            return False
        for p in self.inner._param_list():
            out = collective.all_reduce(Tensor(p.detach()),
                                        op=collective.ReduceOp.AVG)
            with torch.no_grad():
                p.copy_(out._value)
        return True


class DGCOptimizer(MetaOptimizerBase):
    """Top-k sparsified gradients with error feedback (reference
    dgc_optimizer.py, dgc_momentum_op).  Sparsity is applied locally;
    the dense all-reduce stays the caller's (the JAX package documents
    the same communication delta).

    The sparsify pass runs on the device over every parameter with a
    gradient: acc = g + residual, the k-th largest ``|acc|`` by
    ``torch.topk`` (k = max(1, int(n·(1 - sparsity)))), kept = acc where
    ``|acc|`` >= it (ties kept), residual = the rest.  Residuals are
    keyed by parameter NAME, immune to id() reuse after GC."""

    def __init__(self, inner, rampup_begin_step=0, sparsity=0.999):
        super().__init__(inner)
        self.rampup_begin_step = rampup_begin_step
        self.sparsity = sparsity
        self._count = 0
        self._residual = {}

    def sparsify(self, g: torch.Tensor, residual: torch.Tensor):
        """(kept, new residual) of one gradient."""
        acc = g + residual
        flat = acc.abs().reshape(-1)
        k = max(1, int(flat.numel() * (1 - self.sparsity)))
        thresh = torch.topk(flat, k).values[-1]
        mask = acc.abs() >= thresh
        zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
        return torch.where(mask, acc, zero), torch.where(mask, zero, acc)

    def step(self):
        self._count += 1
        if self._count > self.rampup_begin_step:
            owner_of = self.inner._owners()
            params = [p for p in self.inner._param_list()
                      if p.grad is not None]
            for i, p in enumerate(params):
                name = getattr(owner_of.get(id(p)), "name", None) or f"p{i}"
                res = self._residual.get(name)
                kept, self._residual[name] = self.sparsify(
                    p.grad, torch.zeros_like(p.grad) if res is None else res)
                p.grad = kept
        self.inner.step()


class FP16AllreduceOptimizer(MetaOptimizerBase):
    """Round the gradients through a 16-bit type before the update
    (reference fp16_allreduce_optimizer.py).  As the JAX package, the
    type is **bfloat16**, not fp16."""

    def step(self):
        for p in self.inner._param_list():
            if p.grad is not None:
                g = p.grad
                p.grad = g.to(torch.bfloat16).to(g.dtype)
        self.inner.step()


class RecomputeOptimizer(MetaOptimizerBase):
    """Marker wrapper (reference recompute_optimizer.py): the recompute
    itself is ``fleet.recompute`` / ``RecomputeSequential`` applied to
    the layer blocks."""


class ShardingOptimizer(MetaOptimizerBase):
    """ZeRO-style optimizer-state sharding (reference
    sharding_optimizer.py:69): ``init_opt_state`` places every
    accumulator over the mesh's ``axis_name`` (``fleet/sharding.py``)."""

    def __init__(self, inner, sharding_degree=None, axis_name="dp"):
        super().__init__(inner)
        self.axis_name = axis_name

    def init_opt_state(self, params):
        from .sharding import shard_opt_state

        return shard_opt_state(self.inner.init_opt_state(params),
                               axis_name=self.axis_name)


def apply_meta_optimizers(fleet, optimizer: Optimizer, strategy) -> Optimizer:
    """Strategy compiler (reference strategy_compiler.py): wrap in reference
    order.  A knob the JAX package never reads, set away from its
    default, raises (``strategy.refuse_unread``)."""
    refuse_unread(strategy)
    opt = optimizer
    if strategy.lars and not isinstance(opt, Lars):
        opt = Lars(learning_rate=opt._lr, parameters=opt._param_objs,
                   **{k: v for k, v in strategy.lars_configs.items()
                      if k in ("lars_coeff", "lars_weight_decay", "epsilon")})
    if strategy.lamb and not isinstance(opt, Lamb):
        opt = Lamb(learning_rate=opt._lr, parameters=opt._param_objs,
                   lamb_weight_decay=strategy.lamb_configs.lamb_weight_decay)
    if strategy.dgc:
        opt = DGCOptimizer(opt, strategy.dgc_configs.rampup_begin_step,
                           strategy.dgc_configs.sparsity[0])
    if strategy.fp16_allreduce:
        opt = FP16AllreduceOptimizer(opt)
    if strategy.gradient_merge:
        opt = GradientMergeOptimizer(opt,
                                     strategy.gradient_merge_configs.k_steps,
                                     strategy.gradient_merge_configs.avg)
    if strategy.localsgd:
        opt = LocalSGDOptimizer(opt, strategy.localsgd_configs.k_steps,
                                strategy.localsgd_configs.begin_step)
    if strategy.recompute:
        opt = RecomputeOptimizer(opt)
    if strategy.sharding:
        opt = ShardingOptimizer(opt)
    return opt
