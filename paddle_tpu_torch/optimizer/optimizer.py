"""Optimizers — twin of ``paddle_tpu/optimizer/optimizer.py`` for the
paddle dygraph loop ``loss.backward(); opt.step(); opt.clear_grad()``.

``parameters`` may be bare torch tensors (the GPT ``nn.Module``) or the
dygraph core's ``Parameter``s (``layer.parameters()``): the optimizer
keeps each Parameter's torch tensor, so its in-place update is what the
layer holds.

Where the JAX package replaces each parameter's array, the port updates
parameters and accumulators IN PLACE under ``torch.no_grad()`` (the
parameter tensors the model holds are the ones that change).  The update
expressions keep the JAX package's operation order, in f32.

Ported: ``Optimizer`` (``get_lr``/``set_lr``, ``step`` with the float
``weight_decay`` L2 rule, ``clear_grad``, ``state_dict`` /
``set_state_dict`` keyed by position as ``param_{i}_{kind}`` plus
``step_count``), ``SGD``, ``Adam`` and ``AdamW``.  Not ported (each
raises ``InvalidArgumentError`` naming ROADMAP queue 1 item 9): LR
schedulers, ``grad_clip``, regularizer objects, ``apply_decay_param_fun``
(keyed on paddle's creation names, which no port can reproduce) and
``lazy_mode``.
"""
from __future__ import annotations

from numbers import Number
from typing import Dict, List

import torch

from ..framework.errors import InvalidArgumentError
from ..tensor import Tensor

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]


def _unported(what: str):
    raise InvalidArgumentError(
        f"{what} is not ported yet (ROADMAP queue 1 item 9)")


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if isinstance(learning_rate, bool) \
                or not isinstance(learning_rate, Number):
            _unported(f"learning_rate of type {type(learning_rate).__name__}"
                      " (an LR scheduler)")
        if grad_clip is not None:
            _unported("grad_clip")
        if weight_decay is not None and not isinstance(weight_decay, float):
            _unported(f"weight_decay of type {type(weight_decay).__name__} "
                      "(only a float L2 coefficient is ported)")
        self._lr = float(learning_rate)
        self._parameters = (None if parameters is None else
                            [p._value if isinstance(p, Tensor) else p
                             for p in parameters])
        self._l2_coeff = weight_decay        # None: no L2 term
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._step_count = 0

    # --- lr -----------------------------------------------------------
    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value):
        self._lr = float(value)

    # --- state --------------------------------------------------------
    def _acc_kinds(self) -> List[str]:
        return []

    def _acc(self, kind: str, p: torch.Tensor) -> torch.Tensor:
        store = self._accumulators.setdefault(kind, {})
        if id(p) not in store:
            store[id(p)] = torch.zeros_like(p)
        return store[id(p)]

    def _param_list(self) -> List[torch.Tensor]:
        if self._parameters is None:
            raise ValueError("optimizer created without a parameters list; "
                             "pass parameters=")
        return self._parameters

    def state_dict(self):
        """``{"LR_Scheduler": {}, "step_count": n, "param_{i}_{kind}":
        tensor}``, the accumulators keyed by the parameter's position in
        the list (copies: later steps update the live ones in place)."""
        out = {"LR_Scheduler": {}, "step_count": self._step_count}
        params = self._param_list()
        for kind, store in self._accumulators.items():
            for i, p in enumerate(params):
                if id(p) in store:
                    out[f"param_{i}_{kind}"] = store[id(p)].detach().clone()
        return out

    def set_state_dict(self, state_dict):
        """Restore ``step_count`` and every ``param_{i}_{kind}`` present
        (tensors or arrays), copied onto each parameter's device."""
        self._step_count = int(state_dict.get("step_count", 0))
        for kind in self._acc_kinds():
            store = self._accumulators.setdefault(kind, {})
            for i, p in enumerate(self._param_list()):
                key = f"param_{i}_{kind}"
                if key in state_dict:
                    store[id(p)] = torch.as_tensor(
                        state_dict[key], device=p.device).to(
                            p.dtype).clone()

    # --- the update ----------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient, in place:
        the gradient cast to the parameter's dtype, plus ``coeff · p``
        under a float ``weight_decay`` (L2), then the rule.  The span
        ``optimizer/step``."""
        from ..utils.profiler import RecordEvent

        with RecordEvent("optimizer/step"):
            self._step_impl()

    def _step_impl(self):
        params = [p for p in self._param_list()
                  if p.grad is not None and p.requires_grad]
        self._step_count += 1
        lr = self.get_lr()
        for p in params:
            g = p.grad
            if g.dtype != p.dtype:
                g = g.to(p.dtype)
            if self._l2_coeff is not None:
                g = g + self._l2_coeff * p
            self._update_param(p, g, lr)

    def _update_param(self, p, g, lr):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        """Drop every parameter's gradient (``grad = None``, as the JAX
        package's ``clear_grad``)."""
        for p in self._param_list():
            p.grad = None


class SGD(Optimizer):
    def _update_param(self, p, g, lr):
        p.copy_(p - lr * g)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        if lazy_mode:
            _unported("lazy_mode")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _acc_kinds(self):
        return ["moment1", "moment2"]

    def _update_param(self, p, g, lr):
        t = self._step_count
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        gf = g.float()
        new_m = b1 * m.float() + (1 - b1) * gf
        new_v = b2 * v.float() + (1 - b2) * gf * gf
        mhat = new_m / (1 - b1 ** t)
        vhat = new_v / (1 - b2 ** t)
        upd = lr * mhat / (torch.sqrt(vhat) + eps)
        p.copy_(p.float() - upd)
        m.copy_(new_m)
        v.copy_(new_v)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if apply_decay_param_fun is not None:
            _unported("apply_decay_param_fun")
        if lr_ratio is not None:
            _unported("lr_ratio")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd = float(weight_decay)

    def _update_param(self, p, g, lr):
        """Decoupled decay ``p ← p·(1 − lr·wd)`` first, then Adam."""
        p.copy_(p.float() * (1 - lr * self._wd))
        super()._update_param(p, g, lr)
