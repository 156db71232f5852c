"""Optimizers — twin of ``paddle_tpu/optimizer/optimizer.py``.

Every optimizer has one update rule, ``_rule(p, g, accs, lr, step) ->
(new_p, new_accs)``, written in torch with the JAX package's expressions
in their order.  Three entry points share it:

- ``step()``, the paddle dygraph loop ``loss.backward(); opt.step();
  opt.clear_grad()``: the gradients of the parameters that have one are
  clipped (``grad_clip``), regularized (``L2Decay`` adds ``coeff · p``,
  ``L1Decay`` ``coeff · sign(p)``; a float ``weight_decay`` is an
  ``L2Decay``), and each parameter and accumulator is updated IN PLACE
  under ``torch.no_grad()`` — the tensors the model holds are the ones
  that change;
- ``fused_step(params, grads, opt_state, step, lr=None)``, the
  functional form over ``{name: tensor}`` dicts (``init_opt_state`` makes
  the state): the same clip, regularizers and rule, returning new dicts;
- the hapi train step (``hapi/model.py``), which calls
  :meth:`Optimizer._prepare_step` on the host and then
  :meth:`Optimizer._apply_gradients` inside one CUDA graph.

The learning rate and the step count live in 0-d float64 tensors on the
parameters' device.  The host writes them (``fill_``, no sync) before
each step: the scheduler's current value and the new count.  The rules
read them there, so a captured step sees each replay's values.  Bias
corrections such as ``1 - b1 ** step`` are computed in float64 on the
device, rounded to f32, and an f32 tensor is divided by them exactly, as
the JAX package's eager step divides by its Python scalars.  (On the
card, PyTorch divides by a host Python float as a product with the f32
rounding of its reciprocal, which differs in the last bit for about a
third of the entries: ``tools/torch_train_ab.py``.)  The JAX package's
own fused step differs from its eager one (it bakes the learning rate
at trace time and drops ``grad_clip`` and ``L1Decay``; ROADMAP "Known
facts about the reference"); the port follows its eager ``step()`` on
every path.

``parameters`` may be bare torch tensors (the GPT ``nn.Module``) or the
dygraph core's ``Parameter``s (``layer.parameters()``): the optimizer
keeps each Parameter's torch tensor.

``state_dict()`` keeps the JAX package's layout: ``LR_Scheduler`` (the
scheduler's state or ``{}``), ``step_count`` and ``param_{i}_{kind}``
keyed by position.  ``set_state_dict`` accepts it with tensors or numpy
arrays (the JAX package's ``state_dict()`` read out with ``np.asarray``)
and copies into the live accumulators in place.

A ``Parameter``'s own settings (``ParamAttr``) hold on every path, as
in the reference's eager step (``paddle_tpu/optimizer/optimizer.py:
220-243``): ``optimize_attr["learning_rate"]`` scales the learning rate,
its ``regularizer`` takes the place of the optimizer's, and
``need_clip=False`` keeps its gradient out of the clip.  Each update
finds a tensor's Parameter through ``_param_objs`` at that call, so the
settings follow a parameter re-pointed after the optimizer was built
(``amp.decorate`` O2, ``hapi.Model.prepare``), and ``fused_step`` finds
them for a dict of the live tensors.  ``minimize`` runs the backward only while the loss's
graph has not been consumed (``tensor.graph_consumed``), the
reference's rule.

A row-sparse gradient (``embedding(sparse=True)``: a sparse COO tensor
in the parameter's ``grad``) takes the reference's row-wise path
(``paddle_tpu/optimizer/optimizer.py:215-260``) in ``step()``: the rule
(``_sparse_rule``, the reference's ``_rule``) runs on the gathered
touched rows of the parameter and its accumulators
(``sparse_grad.rowwise_update``), with the parameter's learning-rate
scale, without regularization and outside the global clip.  Adam's
``lazy_mode`` is accepted and, as in the JAX package, read by nothing: a
row-sparse gradient takes the row-wise path whatever it says.
``AdamW(apply_decay_param_fun=)`` decides the decay by the Parameter's
``name`` on the dense path; the row-wise path decays the touched rows
always, as the reference's ``_rule`` does.  ``fused_step`` takes dense
gradients, as the reference's does, and ``Lookahead`` refuses a sparse
one (its reference syncs every row of the table every k steps).

Not ported (raises ``InvalidArgumentError``): ``AdamW(lr_ratio=)``, which
the JAX package accepts and never reads.
"""
from __future__ import annotations

from numbers import Number
from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError
from ..framework.flags import flag_value
from ..regularizer import L1Decay, L2Decay
from ..tensor import Tensor, graph_consumed, preserve_saved
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "AdamDelta", "Adadelta", "RMSProp", "Lamb", "Lars",
           "Ftrl", "FtrlOptimizer", "Dpsgd", "DpsgdOptimizer",
           "ModelAverage", "Lookahead", "LookaheadOptimizer"]


def _unported(what: str):
    raise InvalidArgumentError(
        f"{what} is not supported: the JAX package accepts it and never "
        "reads it (ROADMAP \"Known facts about the reference\")")


def _value(t):
    return t._value if isinstance(t, Tensor) else t


def _as_array(v, like: torch.Tensor) -> torch.Tensor:
    """A state entry (tensor, port or JAX-package Tensor, numpy array)
    as a torch tensor on ``like``'s device and dtype."""
    v = _value(v)
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(getattr(v, "_value", v), copy=True))
    return v.to(device=like.device, dtype=like.dtype)


def _scalar(x, device) -> torch.Tensor:
    """A learning rate or step count as a 0-d float64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.tensor(float(x), dtype=torch.float64, device=device)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (Number, LRScheduler)):
            raise InvalidArgumentError(
                "learning_rate must be a float or an LRScheduler, got "
                f"{type(learning_rate).__name__}")
        self._lr = (learning_rate if isinstance(learning_rate, LRScheduler)
                    else float(learning_rate))
        self._param_objs = None if parameters is None else list(parameters)
        self._parameters = (None if parameters is None else
                            [_value(p) for p in self._param_objs])
        self._grad_clip = grad_clip
        if isinstance(weight_decay, float):
            self._regularization = L2Decay(weight_decay)
        elif isinstance(weight_decay, (L1Decay, L2Decay)):
            self._regularization = weight_decay
        else:
            self._regularization = None
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._step_count = 0
        self._lr_t: Optional[torch.Tensor] = None
        self._step_t: Optional[torch.Tensor] = None
        self._step_memo: Dict[str, torch.Tensor] = {}

    # --- lr -----------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is a scheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    @property
    def _learning_rate(self):
        return self._lr

    # --- device scalars --------------------------------------------------
    def _scalars(self):
        """(lr, step): the 0-d float64 tensors on the parameters' device
        the rules read."""
        if self._lr_t is None:
            params = self._param_list()
            dev = params[0].device if params else torch.device("cpu")
            self._lr_t = torch.zeros((), dtype=torch.float64, device=dev)
            self._step_t = torch.zeros((), dtype=torch.float64, device=dev)
        return self._lr_t, self._step_t

    def _prepare_step(self):
        """Count the step and write the current learning rate and the
        new count into the device scalars (host side: outside a graph,
        before the update that reads them)."""
        self._step_count += 1
        lr_t, step_t = self._scalars()
        lr_t.fill_(self.get_lr())
        step_t.fill_(float(self._step_count))

    # --- state --------------------------------------------------------
    def _acc_kinds(self) -> List[str]:
        return []

    def _acc(self, kind: str, p: torch.Tensor) -> torch.Tensor:
        store = self._accumulators.setdefault(kind, {})
        if id(p) not in store:
            store[id(p)] = self._acc_init(kind, p)
        return store[id(p)]

    def _acc_init(self, kind: str, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p)

    def _ensure_state(self, params=None):
        """Make every accumulator of ``params`` (all of them by default)
        now — a CUDA graph binds them by address, so they must exist
        before its first call."""
        for p in (self._param_list() if params is None else params):
            for kind in self._acc_kinds():
                self._acc(kind, p)
        self._scalars()

    def _param_list(self) -> List[torch.Tensor]:
        if self._parameters is None:
            raise ValueError("optimizer created without a parameters list; "
                             "pass parameters= or use it through a Model "
                             "wrapper that supplies them")
        return self._parameters

    def state_dict(self):
        """``{"LR_Scheduler": ..., "step_count": n, "param_{i}_{kind}":
        tensor}``, the accumulators keyed by the parameter's position in
        the list (copies: later steps update the live ones in place)."""
        out = {"LR_Scheduler": (self._lr.state_dict()
                                if isinstance(self._lr, LRScheduler) else {}),
               "step_count": self._step_count}
        params = self._param_list()
        for kind, store in self._accumulators.items():
            for i, p in enumerate(params):
                if id(p) in store:
                    out[f"param_{i}_{kind}"] = store[id(p)].detach().clone()
        return out

    def set_state_dict(self, state_dict):
        """Restore the scheduler, ``step_count`` and every
        ``param_{i}_{kind}`` present (tensors or arrays), copied onto
        each parameter's device — into the live accumulator when it
        exists, so a captured step keeps its addresses."""
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state_dict:
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        self._step_count = int(state_dict.get("step_count", 0))
        params = self._param_list()
        for kind in self._acc_kinds():
            store = self._accumulators.setdefault(kind, {})
            for i, p in enumerate(params):
                key = f"param_{i}_{kind}"
                if key not in state_dict:
                    continue
                cur = store.get(id(p))
                like = cur if cur is not None else self._acc_init(kind, p)
                v = _as_array(state_dict[key], like)
                if cur is not None and cur.shape == v.shape:
                    with torch.no_grad():
                        cur.copy_(v)
                else:
                    store[id(p)] = v.clone()

    set_dict = set_state_dict

    # --- the update ----------------------------------------------------
    def _owners(self):
        """Each Parameter (or bare tensor) by the id of its current torch
        tensor, read from the parameter objects at each call: ``amp.
        decorate`` and ``hapi.Model.prepare`` re-point ``_parameters``
        after the optimizer is built."""
        return {id(_value(o)): o for o in self._param_objs or ()}

    def _regularize(self, p, g, reg=None):
        """``g`` plus the decay of ``reg`` (the parameter's own
        regularizer), else of the optimizer's."""
        if reg is None:
            reg = self._regularization
        if isinstance(reg, L2Decay):
            return g + reg.coeff * p
        if isinstance(reg, L1Decay):
            return g + reg.coeff * torch.sign(p)
        return g

    def _clip(self, params_grads):
        if self._grad_clip is None or not params_grads:
            return params_grads
        return [(p, _value(g)) for p, g in self._grad_clip(params_grads)]

    def _update(self, p, g, accs, lr, step, owner=None):
        """The rule for one parameter, ``owner`` its Parameter (a hook:
        ``Lamb`` passes its per-parameter decay)."""
        return self._rule(p, g, accs, lr, step)

    def _new_step(self):
        """Forget the values the last update shared between parameters."""
        self._step_memo = {}

    def _per_step(self, key, fn):
        """A value every parameter's rule shares within one update (a
        bias correction, a decay factor), made once: a 0-d device kernel
        fewer per parameter."""
        memo = self._step_memo
        if key not in memo:
            memo[key] = fn()
        return memo[key]

    def _updates(self, params_grads, accs_of, lr, step):
        """``(i, new_p, new_accs)`` for each ``i``-th (param, grad) pair
        that has a gradient: clip, the gradient cast to the parameter's
        dtype, regularize, the rule (``accs_of(i, p)`` gives the
        accumulators).  The one pipeline of ``step()``, the graphed hapi
        step and ``fused_step``."""
        self._new_step()
        pairs = list(params_grads)
        owner_of = self._owners()
        owners = [owner_of.get(id(p), p) for p, _ in pairs]
        clipped = self._clip([(o, g) for o, (_, g) in zip(owners, pairs)])
        for i, ((p, _), owner, (_, g)) in enumerate(zip(pairs, owners,
                                                         clipped)):
            if g is None:
                continue
            if g.is_sparse:
                raise InvalidArgumentError(
                    "a row-sparse gradient takes step() (the row-wise "
                    "update); fused_step takes dense gradients, as the "
                    "reference's does")
            if g.dtype != p.dtype:
                g = g.to(p.dtype)
            g = self._regularize(p, g, getattr(owner, "regularizer", None))
            scale = float(getattr(owner, "optimize_attr", {}).get(
                "learning_rate", 1.0))
            p_lr = lr if scale == 1.0 else self._per_step(
                ("lr", scale), lambda: lr * scale)
            yield (i,) + tuple(self._update(p, g, accs_of(i, p), p_lr,
                                            step, owner))

    @torch.no_grad()
    def _apply_gradients(self, params_grads):
        """:meth:`_updates` in place, with the device scalars
        (``_prepare_step`` wrote them): the body ``step()`` and the
        graphed hapi step share.  The row-sparse gradients take
        :meth:`_sparse_update` first, outside the clip."""
        lr, step = self._scalars()
        kinds = self._acc_kinds()
        pairs = []
        for p, g in params_grads:
            if g is not None and g.is_sparse:
                preserve_saved(p)
                self._sparse_update(p, g, lr, step)
            else:
                pairs.append((p, g))

        def accs_of(i, p):
            return {k: self._acc(k, p) for k in kinds}

        for i, new_p, new_accs in self._updates(pairs, accs_of, lr, step):
            p = pairs[i][0]
            preserve_saved(p)
            p.copy_(new_p)
            for k in kinds:
                self._acc(k, p).copy_(new_accs[k])

    def _sparse_update(self, p, g, lr, step):
        """The row-wise update of ``p`` by the sparse COO gradient ``g``:
        ``_sparse_rule`` on the touched rows, the parameter's
        learning-rate scale applied, no regularizer."""
        from ..sparse_grad import IndexedSlices, rowwise_update

        self._new_step()
        owner = self._owners().get(id(p), p)
        scale = float(getattr(owner, "optimize_attr", {}).get(
            "learning_rate", 1.0))
        accs = {k: self._acc(k, p) for k in self._acc_kinds()}
        rowwise_update(self._sparse_rule, p, IndexedSlices.from_coo(g), accs,
                       lr if scale == 1.0 else lr * scale, step)

    def _sparse_rule(self, p, g, accs, lr, step):
        """The rule the row-wise path runs: the reference's ``_rule``."""
        return self._rule(p, g, accs, lr, step)

    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient, in place:
        clip, regularize, then the rule.  The span ``optimizer/step``."""
        from ..utils.profiler import RecordEvent

        with RecordEvent("optimizer/step"):
            self._step_impl()

    def _step_impl(self):
        if flag_value("enable_unused_var_check"):
            owner_of = self._owners()
            unused = [getattr(owner_of.get(id(p)), "name", None)
                      or f"param_{i}"
                      for i, p in enumerate(self._param_list())
                      if p.grad is None and p.requires_grad]
            if unused:
                import warnings

                warnings.warn(
                    f"{len(unused)} trainable parameter(s) received no "
                    f"gradient this step (first few: {unused[:5]}); they "
                    "are not reached by the loss graph", stacklevel=3)
        params = [p for p in self._param_list()
                  if p.grad is not None and p.requires_grad]
        self._prepare_step()
        self._apply_gradients([(p, p.grad) for p in params])
        owner_of = self._owners()
        for p in params:
            owner = owner_of.get(id(p))
            if isinstance(owner, Tensor):
                owner._inplace_version += 1

    def clear_grad(self, set_to_zero=True):
        """Drop every parameter's gradient (``grad = None``, as the JAX
        package's ``clear_grad``)."""
        for p in self._param_list():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The dygraph ``minimize``: run ``loss.backward()`` while the
        loss's graph has not been consumed (so after ``loss.backward();
        opt.minimize(loss)`` it does not run twice, and gradients left by
        an earlier step accumulate, as the reference's do), then
        ``step()``; returns ``(None, [(param, grad)])``.  While a static
        Program records, it records the backward and the update instead
        (:meth:`_static_step`)."""
        from ..ops.dispatch import _recording_program

        prog = _recording_program()
        if prog is not None:
            return self._static_step(prog, loss)
        params = self._param_list()
        if not graph_consumed(loss):
            (loss if isinstance(loss, Tensor) else Tensor(loss)).backward()
        self.step()
        return None, [(p, p.grad) for p in params]

    # --- static-graph path ------------------------------------------------
    def _static_step(self, prog, loss):
        """Record the backward and the parameter update into the static
        Program ``prog`` (reference: optimizer.minimize appends the
        backward and update OpDescs, fluid/optimizer.py; the JAX
        package's ``_static_step``): ``append_backward`` over the
        trainable parameters, then ONE update op — clip, regularizers
        and the rule, as ``step()`` — whose outputs the Program copies
        into the parameters and accumulators after each replay
        (``note_param_update`` / ``note_state``).  The step count and the
        learning rate ride as Program state: the count an int32 counter
        the program increments, the rate refreshed from ``get_lr()`` at
        every run, so Adam's bias correction advances and a scheduler
        applies without rebuilding the program."""
        from ..ops.dispatch import apply
        from ..static.compat import append_backward

        owner_of = self._owners()
        owners = []
        for p in self._param_list():
            owner = owner_of.get(id(p))
            if not isinstance(owner, Tensor):
                raise InvalidArgumentError(
                    "static-mode minimize needs the Layer's Parameters "
                    "(optimizer(parameters=layer.parameters())), not bare "
                    "tensors")
            if p.requires_grad:
                owners.append(owner)
        pairs = append_backward(loss, owners)
        slots = self.__dict__.setdefault("_static_slots", {})
        if id(prog) not in slots:
            dev = owners[0]._value.device
            step_t = Tensor(torch.zeros((), dtype=torch.int32, device=dev))
            new_step = apply("increment_step", lambda v: v + 1, step_t)
            prog.note_state(step_t, updated=new_step)
            lr_t = Tensor(torch.tensor(self.get_lr(), dtype=torch.float64,
                                       device=dev))
            prog.note_state(lr_t, refresh=lambda: torch.tensor(
                self.get_lr(), dtype=torch.float64, device=dev),
                spec=("lr", self._lr))
            slots[id(prog)] = (lr_t, new_step, prog)
        lr_t, new_step, _ = slots[id(prog)]
        self._step_count += 1
        kinds = self._acc_kinds()
        self._ensure_state([o._value for o, _ in pairs])
        accs = [Tensor(self._acc(k, o._value)) for o, _ in pairs
                for k in kinds]
        n, nk = len(pairs), len(kinds)

        def upd(lrv, sv, *vals):
            ps, gs, av = vals[:n], vals[n:2 * n], vals[2 * n:]
            new_p, new_a = list(ps), list(av)

            def accs_of(i, p):
                return {k: av[i * nk + j] for j, k in enumerate(kinds)}

            with torch.no_grad():
                for i, np_, na in self._updates(
                        list(zip(ps, gs)), accs_of, lrv,
                        sv.to(torch.float64)):
                    new_p[i] = np_
                    for j, k in enumerate(kinds):
                        new_a[i * nk + j] = na[k]
            return tuple(new_p) + tuple(new_a)

        outs = apply(f"{type(self).__name__.lower()}_update", upd, lr_t,
                     new_step, *[o for o, _ in pairs],
                     *[g for _, g in pairs], *accs)
        for (o, _), new in zip(pairs, outs[:n]):
            prog.note_param_update(o, new)
        for t, new in zip(accs, outs[n:]):
            prog.note_state(t, updated=new)
        return None, pairs

    # --- functional path -------------------------------------------------
    def init_opt_state(self, params: Dict[str, torch.Tensor]):
        """Functional accumulators ``{kind: {name: tensor}}``."""
        return {kind: {k: self._acc_init(kind, v) for k, v in params.items()}
                for kind in self._acc_kinds()}

    @torch.no_grad()
    def fused_step(self, params, grads, opt_state, step, lr=None,
                   master_params=None):
        """The whole-dict update: ``params``/``grads`` ``{name: tensor}``
        (a None gradient leaves its parameter), ``step`` the new count.
        The same clip, regularizers and rule as ``step()``; returns
        ``(new_params, new_opt_state)``."""
        kinds = self._acc_kinds()
        names = list(params)
        first = params[names[0]] if names else torch.zeros(())
        lr = _scalar(self.get_lr() if lr is None else lr, first.device)
        step = _scalar(step, first.device)
        new_params = dict(params)
        new_state = {kind: dict(opt_state[kind]) for kind in kinds}

        def accs_of(i, p):
            return {kind: opt_state[kind][names[i]] for kind in kinds}

        pairs = [(params[n], grads.get(n)) for n in names]
        for i, new_p, new_accs in self._updates(pairs, accs_of, lr, step):
            new_params[names[i]] = new_p
            for kind in kinds:
                new_state[kind][names[i]] = new_accs[kind]
        return new_params, new_state

    def _rule(self, p, g, accs, lr, step):
        raise NotImplementedError


def _f32(x):
    """A 0-d scalar as the JAX package's weak-typed Python float meets an
    f32 0-d array: rounded to f32."""
    return x.float() if isinstance(x, torch.Tensor) else x


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _rule(self, p, g, accs, lr, step):
        return p - lr * g, {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _acc_kinds(self):
        return ["velocity"]

    def _rule(self, p, g, accs, lr, step):
        new_v = self._momentum * accs["velocity"] + g
        if self._nesterov:
            new_p = p - lr * (g + self._momentum * new_v)
        else:
            new_p = p - lr * new_v
        return new_p, {"velocity": new_v}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _acc_kinds(self):
        return ["moment"]

    def _rule(self, p, g, accs, lr, step):
        new_m = accs["moment"] + g * g
        return (p - lr * g / (torch.sqrt(new_m) + self._epsilon),
                {"moment": new_m})


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode
        self._multi_precision = multi_precision

    def _acc_kinds(self):
        return ["moment1", "moment2"]

    def _rule(self, p, g, accs, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        gf = g.float()
        m = b1 * accs["moment1"].float() + (1 - b1) * gf
        v = b2 * accs["moment2"].float() + (1 - b2) * gf * gf
        mhat = m / self._per_step("bc1", lambda: _f32(1 - b1 ** step))
        vhat = v / self._per_step("bc2", lambda: _f32(1 - b2 ** step))
        new_p = (p.float() - lr * mhat / (torch.sqrt(vhat) + eps)).to(p.dtype)
        return new_p, {"moment1": m.to(accs["moment1"].dtype),
                       "moment2": v.to(accs["moment2"].dtype)}


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            _unported("AdamW(lr_ratio=)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd = float(weight_decay)
        self._apply_decay_fn = apply_decay_param_fun

    def _update(self, p, g, accs, lr, step, owner=None):
        """Adam without the decay for a parameter whose ``name``
        ``apply_decay_param_fun`` turns down."""
        fn = self._apply_decay_fn
        if fn is not None and not fn(getattr(owner, "name", None)):
            return Adam._rule(self, p, g, accs, lr, step)
        return self._rule(p, g, accs, lr, step)

    def _rule(self, p, g, accs, lr, step):
        """Decoupled decay ``p ← p·(1 − lr·wd)`` first, then Adam."""
        keep = self._per_step(("keep", id(lr)), lambda: 1 - lr * self._wd)
        decayed = (p.float() * keep).to(p.dtype)
        return super()._rule(decayed, g, accs, lr, step)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _acc_kinds(self):
        return ["moment", "inf_norm"]

    def _rule(self, p, g, accs, lr, step):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * accs["moment"] + (1 - b1) * g
        u = torch.maximum(b2 * accs["inf_norm"], torch.abs(g))
        lr_t = self._per_step(("lr_t", id(lr)),
                              lambda: lr / (1 - b1 ** step))
        return p - lr_t * m / (u + eps), {"moment": m, "inf_norm": u}


class AdamDelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _acc_kinds(self):
        return ["avg_squared_grad", "avg_squared_update"]

    def _rule(self, p, g, accs, lr, step):
        rho, eps = self._rho, self._epsilon
        eu = accs["avg_squared_update"]
        new_eg = rho * accs["avg_squared_grad"] + (1 - rho) * g * g
        upd = torch.sqrt(eu + eps) / torch.sqrt(new_eg + eps) * g
        new_eu = rho * eu + (1 - rho) * upd * upd
        return p - lr * upd, {"avg_squared_grad": new_eg,
                              "avg_squared_update": new_eu}


Adadelta = AdamDelta


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _acc_kinds(self):
        return ["mean_square", "mean_grad", "momentum"]

    def _rule(self, p, g, accs, lr, step):
        rho, eps = self._rho, self._epsilon
        new_ms = rho * accs["mean_square"] + (1 - rho) * g * g
        if self._centered:
            new_mg = rho * accs["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(new_ms - new_mg * new_mg + eps)
        else:
            new_mg = accs["mean_grad"]
            denom = torch.sqrt(new_ms + eps)
        new_mom = self._momentum * accs["momentum"] + lr * g / denom
        return p - new_mom, {"mean_square": new_ms, "mean_grad": new_mg,
                             "momentum": new_mom}


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _acc_kinds(self):
        return ["moment1", "moment2"]

    def _update(self, p, g, accs, lr, step, owner=None):
        wd = self._wd
        if self._exclude_fn is not None:
            if owner is None:
                owner = self._owners().get(id(p), p)
            if self._exclude_fn(owner):
                wd = 0.0
        return self._rule(p, g, accs, lr, step, wd)

    def _rule(self, p, g, accs, lr, step, wd=None):
        wd = self._wd if wd is None else wd
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        gf, pf = g.float(), p.float()
        m = b1 * accs["moment1"].float() + (1 - b1) * gf
        v = b2 * accs["moment2"].float() + (1 - b2) * gf * gf
        mhat = m / self._per_step("bc1", lambda: _f32(1 - b1 ** step))
        vhat = v / self._per_step("bc2", lambda: _f32(1 - b2 ** step))
        r = mhat / (torch.sqrt(vhat) + eps) + wd * pf
        w_norm = torch.linalg.vector_norm(pf)
        r_norm = torch.linalg.vector_norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        lr32 = self._per_step(("lr32", id(lr)), lambda: _f32(lr))
        new_p = (pf - lr32 * ratio * r).to(p.dtype)
        return new_p, {"moment1": m, "moment2": v}


class Lars(Momentum):
    """LARS: momentum with the layer-wise rate
    ``coeff · |w| / (|g| + wd · |w| + eps)`` (1 where a norm is 0).  The
    JAX package's fused step runs plain Momentum for it (its ``_rule``);
    the port runs the eager LARS update on every path."""

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._lars_eps = epsilon

    def _sparse_rule(self, p, g, accs, lr, step):
        """The row-wise path runs plain Momentum, the reference's
        ``_rule`` for Lars."""
        return Momentum._rule(self, p, g, accs, lr, step)

    def _rule(self, p, g, accs, lr, step):
        pf, gf = p.float(), g.float()
        w_norm = torch.linalg.vector_norm(pf)
        g_norm = torch.linalg.vector_norm(gf)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm
            / (g_norm + self._lars_wd * w_norm + self._lars_eps),
            torch.ones_like(w_norm))
        lr32 = self._per_step(("lr32", id(lr)), lambda: _f32(lr))
        new_v = self._momentum * accs["velocity"] + lr32 * local_lr * (
            gf + self._lars_wd * pf)
        return (pf - new_v).to(p.dtype), {"velocity": new_v}


class Ftrl(Optimizer):
    """FTRL-proximal: squared and linear accumulators, the
    ``lr_power=-0.5`` fast path and the l1 soft-threshold shrink."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, regularization,
                         grad_clip, name)
        # as the reference: + 1e-10 so sign/compare never sees exact zero
        self._l1 = float(l1) + 1e-10
        self._l2 = float(l2) + 1e-10
        self._lr_power = float(lr_power)

    def _acc_kinds(self):
        return ["squared", "linear"]

    def _rule(self, p, g, accs, lr, step):
        sq, lin = accs["squared"], accs["linear"]
        new_sq = sq + g * g
        if self._lr_power == -0.5:
            sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
            y = torch.sqrt(new_sq) / lr + 2.0 * self._l2
        else:
            sigma = (new_sq ** -self._lr_power
                     - sq ** -self._lr_power) / lr
            y = new_sq ** -self._lr_power / lr + 2.0 * self._l2
        new_lin = lin + g - sigma * p
        x = self._l1 * torch.sign(new_lin) - new_lin
        new_p = torch.where(torch.abs(new_lin) > self._l1, x / y,
                            torch.zeros_like(x))
        return new_p.to(p.dtype), {"squared": new_sq, "linear": new_lin}


FtrlOptimizer = Ftrl


class Dpsgd(Optimizer):
    """Differentially private SGD: each gradient clipped to L2 norm
    ``clip``, plus one gaussian scalar of std ``sigma`` scaled by
    ``1 / batch_size``.  The noise draws from the port's generator of the
    parameter's device (``framework.random``), so its bits are not the
    JAX package's threefry bits: parity is the clip exactly and the
    noise's mean and spread."""

    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1e-8, parameters=None, seed=0, name=None):
        super().__init__(learning_rate, parameters, None, None, name)
        self._clip_norm = float(clip)
        self._batch_size = float(batch_size)
        self._sigma = float(sigma)

    def _rule(self, p, g, accs, lr, step):
        from ..framework.random import generator

        l2 = torch.sqrt(torch.sum(g.float() ** 2))
        scale = torch.where(l2 > self._clip_norm, l2 / self._clip_norm,
                            torch.ones_like(l2))
        noise = torch.randn((), generator=generator(p.device),
                            device=p.device) * self._sigma
        return p - lr * (g / scale + noise / self._batch_size), {}


DpsgdOptimizer = Dpsgd


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging, run BESIDE the training
    optimizer: ``step()`` after each update accumulates the current
    weights; ``apply()`` swaps the averages in (in place) and
    ``restore()`` (or leaving ``apply()``'s context) swaps back."""

    _MAX_NUM_ACCUMULATES = 16384

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 regularization=None, name=None):
        super().__init__(0.0, parameters, regularization, None, name)
        self._avg_rate = float(average_window_rate)
        self._min_window = int(min_average_window)
        self._max_window = int(max_average_window)
        self._num_updates = 0
        self._num_accumulates = 0
        self._old_num_accumulates = 0
        self._backup = None

    def _acc_kinds(self):
        return ["sum_1", "sum_2", "sum_3"]

    def state_dict(self):
        out = super().state_dict()
        out["ma_num_updates"] = self._num_updates
        out["ma_num_accumulates"] = self._num_accumulates
        out["ma_old_num_accumulates"] = self._old_num_accumulates
        return out

    def set_state_dict(self, state_dict):
        super().set_state_dict(state_dict)
        self._num_updates = int(state_dict.get("ma_num_updates", 0))
        self._num_accumulates = int(state_dict.get("ma_num_accumulates", 0))
        self._old_num_accumulates = int(
            state_dict.get("ma_old_num_accumulates", 0))

    @torch.no_grad()
    def step(self):
        """Accumulate the current parameter values (sum_1 += param;
        rotate the windows)."""
        self._num_updates += 1
        self._num_accumulates += 1
        rotate = (self._num_accumulates >= self._min_window
                  and self._num_accumulates >= min(
                      self._max_window,
                      self._num_updates * self._avg_rate))
        for p in self._param_list():
            s1, s2, s3 = (self._acc(k, p) for k in self._acc_kinds())
            n1 = s1 + p
            n2 = s2
            if self._num_updates % self._MAX_NUM_ACCUMULATES == 0:
                n2 = s2 + n1
                n1 = torch.zeros_like(n1)
            if rotate:
                s3.copy_(n1 + n2)
                n1 = torch.zeros_like(n1)
                n2 = torch.zeros_like(n2)
            s1.copy_(n1)
            s2.copy_(n2)
        if rotate:
            self._old_num_accumulates = self._num_accumulates
            self._num_accumulates = 0

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()

    def fused_step(self, params, grads, opt_state, step, lr=None,
                   master_params=None):
        raise TypeError(
            "ModelAverage is not a training optimizer — it accumulates "
            "BESIDE one (call ma.step() after the trainer's step(), then "
            "apply()/restore() around evaluation); it has no fused "
            "update rule.")

    _rule = fused_step

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        """Swap the averaged weights in; leaving the returned context
        restores them when ``need_restore``."""
        total = self._num_accumulates + self._old_num_accumulates
        if total == 0:
            raise RuntimeError("ModelAverage.apply before any step()")
        if self._backup:
            raise RuntimeError(
                "ModelAverage.apply while averaged weights are already "
                "applied — restore() first (a second apply would back up "
                "the averaged values and lose the training weights)")
        self._backup = {}
        for p in self._param_list():
            self._backup[id(p)] = p.detach().clone()
            avg = (self._acc("sum_1", p) + self._acc("sum_2", p)
                   + self._acc("sum_3", p)) / float(total)
            p.copy_(avg.to(p.dtype))
        return _RestoreGuard(self, need_restore)

    @torch.no_grad()
    def restore(self, executor=None):
        if not self._backup:
            return
        for p in self._param_list():
            if id(p) in self._backup:
                p.copy_(self._backup[id(p)])
        self._backup = None


class _RestoreGuard:
    def __init__(self, ma, need_restore):
        self._ma = ma
        self._need_restore = need_restore

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._need_restore:
            self._ma.restore()
        return False


class Lookahead(Optimizer):
    """Lookahead around an inner optimizer: the inner rule advances the
    fast weights every step; every ``k`` steps the slow weights move
    toward them and the fast weights reset onto the slow ones
    (``slow += alpha · (fast − slow); fast = slow``).  The slow weights
    ride as the accumulator ``slow`` (zero until step 1, where they are
    the parameters), the sync is a device-side select on the step
    count, so the eager and the graphed paths run one rule.  The
    learning rate, clip and regularizer are the inner optimizer's.
    ``state_dict`` keeps the JAX package's layout: ``inner`` (the inner
    optimizer's dict), ``k_count`` and ``slow_{i}``."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert inner_optimizer is not None, "inner optimizer can not be None"
        assert 0.0 <= alpha <= 1.0, "alpha should be in [0, 1]"
        assert isinstance(k, int) and k > 0, "k should be a positive integer"
        super().__init__(inner_optimizer._lr, inner_optimizer._param_objs,
                         weight_decay=inner_optimizer._regularization,
                         grad_clip=inner_optimizer._grad_clip)
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def _acc_kinds(self):
        return (["inner_" + k for k in self.inner_optimizer._acc_kinds()]
                + ["slow"])

    def init_opt_state(self, params):
        state = super().init_opt_state(params)
        state["slow"] = {k: v.detach().clone() for k, v in params.items()}
        return state

    def _rule(self, p, g, accs, lr, step):
        inner_accs = {k[len("inner_"):]: v for k, v in accs.items()
                      if k != "slow"}
        fast, new_inner = self.inner_optimizer._update(p, g, inner_accs, lr,
                                                       step)
        slow = torch.where(self._per_step("first", lambda: step == 1), p,
                           accs["slow"])
        sync = self._per_step("sync",
                              lambda: torch.remainder(step, self.k) == 0)
        synced = slow + self.alpha * (fast - slow)
        out = {"inner_" + k: v for k, v in new_inner.items()}
        out["slow"] = torch.where(sync, synced, slow)
        return torch.where(sync, synced, fast), out

    def _prepare_step(self):
        super()._prepare_step()
        self.inner_optimizer._step_count = self._step_count

    def _sparse_update(self, p, g, lr, step):
        raise InvalidArgumentError(
            "Lookahead over a row-sparse gradient is not ported: its "
            "reference moves every row of the table every k steps")

    def _new_step(self):
        super()._new_step()
        self.inner_optimizer._new_step()

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def set_lr(self, value):
        self.inner_optimizer.set_lr(value)
        self._lr = self.inner_optimizer._lr

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad()

    clear_gradients = clear_grad

    def state_dict(self):
        own = super().state_dict()
        inner = {"LR_Scheduler": own["LR_Scheduler"],
                 "step_count": self._step_count}
        out = {"inner": inner, "k_count": self._step_count}
        for key, v in own.items():
            if key.endswith("_slow"):
                out["slow_" + key[len("param_"):-len("_slow")]] = v
            elif key.startswith("param_"):
                i, kind = key[len("param_"):].split("_inner_", 1)
                inner[f"param_{i}_{kind}"] = v
        return out

    def set_state_dict(self, state):
        inner = dict(state.get("inner", {}))
        flat = {"LR_Scheduler": inner.pop("LR_Scheduler", {}),
                "step_count": int(state.get("k_count",
                                            inner.get("step_count", 0)))}
        inner.pop("step_count", None)
        for key, v in inner.items():
            i, kind = key[len("param_"):].split("_", 1)
            flat[f"param_{i}_inner_{kind}"] = v
        n = len(self._param_list())
        slow = {k: v for k, v in state.items() if k.startswith("slow_")}
        if slow and len(slow) != n:
            raise ValueError(
                f"Lookahead state holds {len(slow)} slow weights for {n} "
                "parameters; refusing a partial restore")
        for key, v in slow.items():
            flat[f"param_{key[len('slow_'):]}_slow"] = v
        super().set_state_dict(flat)
        self.inner_optimizer._step_count = self._step_count


LookaheadOptimizer = Lookahead
