"""Static Program / Executor — twin of ``paddle_tpu/static/program.py``
(reference: fluid/framework.py Program :4174, fluid/executor.py
Executor.run :916, framework.proto:201 ProgramDesc).

While a Program is being built (inside ``program_guard``) every op
dispatched through ``ops.dispatch.apply`` is appended to it as an
:class:`OpRecord`: the op's function, the program slots that feed it
and the slots it fills.  Build-time execution runs each op once on
placeholders — fake tensors of torch's ``FakeTensorMode``, which carry
shape, dtype and device but no data — so shapes are inferred and no
kernel is launched (the JAX package builds on zero-filled arrays).  A
real tensor an op reads at build time (a parameter, a constant) is
converted to its fake twin, the same twin every time, so a recorded
backward (``append_backward``) reaches the parameters' twins.

``Executor.run`` replays the records as a function of the feeds, the
parameter slots and the state slots (optimizer accumulators, the step
counter, the learning rate), eagerly, op by op, on the card by
default: the records a fetch, a parameter update or a state update
needs, in order (the JAX package's jitted replay drops the others by
dead-code elimination).  One replay is built per (program version,
fetch list, feed signature) and counted once in
``profiler.jit_cost.compile_ledger`` as ``static/executor``; there is no
CUDA graph of it (a graph of a replay is a speed change, ROADMAP
step B).  A program with a recorded backward replays with grad
enabled, so ``torch.autograd`` differentiates the replayed forward.

Parameters and optimizer state are updated IN PLACE after a replay:
the new value of each updated slot is copied into the parameter's
(or the state tensor's) own storage, so the layer, the optimizer's
accumulators and anything else holding them see the trained values
(the JAX package rebinds ``_value``).

Serialization is ``torch.export`` (``framework.export_compat``):
``Program.save`` writes the inference replay (feeds and parameters in,
fetches out) and its parameters, ``save_train`` the whole train step
(feeds, parameters and state in; fetches, new parameters and new state
out).  Both reload in a fresh process without the model code
(:func:`load_inference_program`, :func:`load_train_program`).
"""
from __future__ import annotations

import contextlib
import os
import pickle
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..framework import dtype as _dt
from ..framework.errors import InvalidArgumentError
from ..framework.export_compat import (export_scope, is_placeholder,
                                       torch_export)
from ..tensor import Parameter, Tensor

__all__ = ["Variable", "OpRecord", "Program", "Executor", "CompiledProgram",
           "Scope", "LoadedProgram", "LoadedTrainProgram", "data",
           "program_guard", "default_main_program",
           "default_startup_program", "global_scope", "scope_guard",
           "suspend_recording", "load_inference_program",
           "load_train_program", "fake_mode", "feed_placeholder"]

_FAKE = {}


def fake_mode():
    """The one ``FakeTensorMode`` the programs build in (real inputs are
    converted on first use, and the same tensor always to the same fake
    twin)."""
    mode = _FAKE.get("mode")
    if mode is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        mode = _FAKE["mode"] = FakeTensorMode(allow_non_fake_inputs=True)
    return mode


def _as_fake(v):
    if not isinstance(v, torch.Tensor) or is_placeholder(v):
        return v
    return fake_mode().from_tensor(v)


def _numpy(v: torch.Tensor) -> np.ndarray:
    return Tensor(v).numpy()


class Variable(Tensor):
    """A feed placeholder (reference framework.py:978 Variable): a fake
    tensor of the declared shape, ``None``/-1 dims as 1."""

    def __init__(self, shape, dtype, name, device=None):
        from ..framework.place import to_device

        concrete = tuple(1 if (s is None or s < 0) else int(s)
                         for s in shape)
        with fake_mode():
            value = torch.zeros(concrete, dtype=_dt.convert_dtype(dtype),
                                device=to_device(device))
        super().__init__(value, stop_gradient=True, name=name)
        self.declared_shape = tuple(-1 if (s is None or s < 0) else int(s)
                                    for s in shape)
        self.is_data = True


class OpRecord:
    """One recorded op (OpDesc analog, framework.proto:43): ``fn``, its
    inputs (Tensors and raw values) with their slots (``None`` for a raw
    value), the dtype each Tensor input was cast to by AMP (or None),
    and the slots of its flat outputs (``None`` for a non-tensor
    output).  An input slot the replay does not fill is a late-bound
    external: its Tensor's value is read at replay time."""

    __slots__ = ("name", "fn", "inputs", "kwargs", "out_tensors", "single",
                 "casts", "in_slots", "out_slots")

    def __init__(self, name, fn, inputs, kwargs, out_tensors, single,
                 casts, in_slots, out_slots):
        self.name = name
        self.fn = fn
        self.inputs = inputs
        self.kwargs = kwargs
        self.out_tensors = out_tensors
        self.single = single
        self.casts = casts
        self.in_slots = in_slots
        self.out_slots = out_slots


class Program:
    """Recorded op graph + feed/parameter/state registry
    (framework.py:4174)."""

    def __init__(self):
        self.feed_vars: List[Variable] = []
        self.records: List[OpRecord] = []
        self.random_seed = 0
        self._slot_of: Dict[int, int] = {}
        self._nslots = 0
        self._params: Dict[int, Parameter] = {}      # slot -> Parameter
        self._state_writeback = {}                   # slot -> (tensor, ...)
        self._state_updates: Dict[int, int] = {}     # state slot -> new slot
        self._param_updates: Dict[int, int] = {}     # param slot -> new slot
        self._grad_feeds = set()     # feed slots a recorded grad reads
        self._version = 0

    def _slot(self, t) -> int:
        """Slot of Tensor ``t``, assigning a fresh one on first sight.
        Every slotted Tensor is held by the program (a record, a feed,
        a parameter or a state entry), so its ``id`` stays its own."""
        s = self._slot_of.get(id(t))
        if s is None:
            s = self._nslots
            self._nslots += 1
            self._slot_of[id(t)] = s
        return s

    def _require_slot(self, t, what: str) -> int:
        s = self._slot_of.get(id(t))
        if s is None:
            raise KeyError(
                f"{what}: tensor is unknown to this program "
                f"(feeds: {[v.name for v in self.feed_vars]}; "
                f"recorded outputs: "
                f"{[t2.name for r in self.records for t2 in r.out_tensors if t2 is not None][:10]})")
        return s

    def slot_of(self, t):
        """The slot of a build-time Tensor, or None."""
        return self._slot_of.get(id(t))

    # --- recording ---------------------------------------------------------
    def record(self, name, fn, args, kwargs):
        """Run op ``name`` once on placeholders and append it: the
        build-time half of ``ops.dispatch.apply``."""
        from ..amp.auto_cast import cast_inputs

        fakes = [_as_fake(a._value) for a in args if isinstance(a, Tensor)]
        casts, values = [], []
        try:
            with fake_mode():
                cast = iter(cast_inputs(name, *fakes))
                for a in args:
                    if isinstance(a, Tensor):
                        v = next(cast)
                        casts.append(v.dtype if v.dtype != a._value.dtype
                                     else None)
                        values.append(v)
                    else:
                        casts.append(None)
                        values.append(a)
                out = fn(*values, **kwargs)
        except Exception as e:
            raise RuntimeError(f"[operator < {name} >] {e}") from e
        single = not isinstance(out, (tuple, list))
        flat = (out,) if single else tuple(out)
        wrapped = [Tensor(o) if isinstance(o, torch.Tensor) else o
                   for o in flat]
        self.add_record(name, fn, args, kwargs, wrapped, single, casts)
        return wrapped[0] if single else type(out)(wrapped)

    def add_record(self, name, fn, args, kwargs, outputs, single, casts):
        inputs = list(args)
        in_slots = []
        for a in inputs:
            if isinstance(a, Parameter):
                self._params[self._slot(a)] = a
            in_slots.append(self._slot(a) if isinstance(a, Tensor)
                            else None)
        out_slots = []
        for o in outputs:
            if isinstance(o, Tensor):
                s = self._slot(o)
                if o.name is None:
                    o.name = f"{name}_{s}.tmp_0"
                out_slots.append(s)
            else:
                out_slots.append(None)
        self.records.append(OpRecord(
            name, fn, inputs, dict(kwargs),
            [o if isinstance(o, Tensor) else None for o in outputs],
            single, casts, in_slots, out_slots))
        self._version += 1

    def note_param_update(self, param, new_tensor):
        """Optimizer hook: after a replay the value of ``new_tensor``'s
        slot is copied into ``param`` in place (the static update op,
        fluid/optimizer.py minimize)."""
        pslot = self._slot(param)
        new_slot = self._require_slot(
            new_tensor, "note_param_update (updated tensor)")
        self._params[pslot] = param
        self._param_updates[pslot] = new_slot
        self._version += 1

    def note_state(self, tensor, setter=None, updated=None, refresh=None,
                   spec=("plain", None)):
        """Register mutable state (an optimizer accumulator, the step
        counter, the learning rate): ``tensor``'s value feeds its slot at
        every run (or ``refresh()``'s, e.g. the scheduler's current
        learning rate); after a replay the value of ``updated``'s slot is
        copied into ``tensor`` in place and passed to ``setter``.
        ``spec`` is the state's serializable descriptor for
        ``save_train``: ``("plain", None)`` a carried value, ``("lr",
        lr_or_scheduler)`` the learning rate."""
        tslot = self._slot(tensor)
        self._state_writeback[tslot] = (tensor, setter, refresh, spec)
        if updated is not None:
            self._state_updates[tslot] = self._require_slot(
                updated, "note_state (updated tensor)")
        self._version += 1

    # --- introspection -----------------------------------------------------
    def global_block(self):
        return self

    def clone(self, for_test=False):
        return self

    def all_parameters(self):
        return list(self._params.values())

    parameters = all_parameters

    def list_vars(self):
        return list(self.feed_vars)

    def __repr__(self):
        return (f"Program(feeds={[v.name for v in self.feed_vars]}, "
                f"ops={len(self.records)})")

    # --- replay ------------------------------------------------------------
    def _needed(self, roots):
        """The records the slots ``roots`` depend on, in program order."""
        want = set(roots)
        keep = []
        for rec in reversed(self.records):
            if any(s in want for s in rec.out_slots if s is not None):
                keep.append(rec)
                want.update(s for s in rec.in_slots if s is not None)
        return keep[::-1]

    def _replay_fn(self, fetch_slots, train=True):
        """The replay: ``(feed values, parameter values, state values) ->
        (fetches, new parameter values, new state values)`` over the
        program's slots.  ``train=False`` replays only what the fetches
        need (an inference program)."""
        feed_slots = [self._slot(v) for v in self.feed_vars]
        param_items = sorted(self._params.items())
        state_items = sorted(self._state_writeback.items())
        roots = list(fetch_slots)
        if train:
            roots += list(self._param_updates.values())
            roots += list(self._state_updates.values())
        records = self._needed(roots)
        grad = any(r.name in ("append_backward", "gradients")
                   for r in records)
        grad_feeds = self._grad_feeds

        def run(feed_vals, param_vals, state_vals):
            env: Dict[int, Any] = {}
            for fs, val in zip(feed_slots, feed_vals):
                if grad and fs in grad_feeds and val.is_floating_point():
                    val = val.detach().requires_grad_(True)
                env[fs] = val
            for (ps, _), val in zip(param_items, param_vals):
                env[ps] = val
            for (ss, _), val in zip(state_items, state_vals):
                env[ss] = val
            with suspend_recording(), torch.set_grad_enabled(grad):
                for rec in records:
                    call = []
                    for a, slot, cast in zip(rec.inputs, rec.in_slots,
                                             rec.casts):
                        if not isinstance(a, Tensor):
                            call.append(a)
                            continue
                        v = env.get(slot, a._value)
                        if cast is not None and v.is_floating_point() \
                                and v.dtype != cast:
                            v = v.to(cast)
                        call.append(v)
                    out = rec.fn(*call, **rec.kwargs)
                    flat = (out,) if rec.single else tuple(out)
                    for oslot, val in zip(rec.out_slots, flat):
                        if oslot is not None:
                            env[oslot] = val
            fetches = [env[s] for s in fetch_slots]
            new_params = [env.get(self._param_updates[ps])
                          if ps in self._param_updates else None
                          for ps, _ in param_items]
            new_states = [env.get(self._state_updates[ss])
                          if ss in self._state_updates else None
                          for ss, _ in state_items]
            return fetches, new_params, new_states

        return run, param_items, state_items

    def _producible_slots(self):
        out = {self._slot(v) for v in self.feed_vars}
        out.update(self._params)
        out.update(self._state_writeback)
        for r in self.records:
            out.update(s for s in r.out_slots if s is not None)
        return out

    def _fetch_slot(self, t):
        """A fetch target's slot; it must be one the replay fills."""
        s = self._require_slot(t, "fetch target")
        if s not in self._producible_slots():
            raise KeyError(
                "fetch target is an external input of this program, not a "
                "feed/parameter/state/op output — fetch its producer or "
                "read its .numpy() directly")
        return s

    def _example_feeds(self):
        """Real zero feeds of the placeholders' shapes, for an export."""
        return [torch.zeros(tuple(v._value.shape), dtype=v._value.dtype,
                            device=v._value.device)
                for v in self.feed_vars]

    # --- serialization (torch.export, framework.proto analog) ---------------
    def save(self, path, fetch_list):
        """Write the inference replay (feeds and parameters in, fetches
        out) as ``<path>.program`` (a ``torch.export`` program) and the
        parameters as ``<path>.params`` (numpy, pickled);
        :func:`load_inference_program` runs it in a fresh process without
        the model code."""
        ex = torch_export()
        fetch_slots = [self._fetch_slot(f) for f in fetch_list]
        run, param_items, state_items = self._replay_fn(fetch_slots,
                                                        train=False)
        states = [t._value for _, (t, *_rest) in state_items]

        class Infer(torch.nn.Module):
            def forward(self, feed_vals, param_vals):
                return tuple(run(list(feed_vals), list(param_vals),
                                 states)[0])

        params = [p._value.detach() for _, p in param_items]
        with torch.no_grad(), export_scope():
            prog = ex.export(Infer(), (tuple(self._example_feeds()),
                                       tuple(params)), strict=False)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        ex.save(prog, path + ".program")
        with open(path + ".params", "wb") as f:
            pickle.dump({"params": [_numpy(v) for v in params],
                         "feed_names": [v.name for v in self.feed_vars],
                         "n_fetch": len(fetch_list)}, f, protocol=4)

    def save_train(self, path, fetch_list):
        """Write the whole train step — feeds, parameters and optimizer
        state in; fetches, new parameters and new state out — as
        ``<path>.trainprogram`` (``torch.export``, the backward included)
        and the values as ``<path>.trainstate``, so a fresh process
        resumes training without the model code (reference
        framework.proto:201 + save_persistables)."""
        ex = torch_export()
        fetch_slots = [self._fetch_slot(f) for f in fetch_list]
        run, param_items, state_items = self._replay_fn(fetch_slots)
        specs = [spec for _, (_t, _s, _r, spec) in state_items]
        trained = [ps in self._param_updates for ps, _ in param_items]

        class Step(torch.nn.Module):
            def forward(self, feed_vals, param_vals, state_vals):
                ps = [p.detach().requires_grad_(t) for p, t in
                      zip(param_vals, trained)]
                fetches, new_params, new_states = run(
                    list(feed_vals), ps, list(state_vals))
                return (tuple(f.detach() for f in fetches),
                        tuple((n if n is not None else p).detach()
                              for n, p in zip(new_params, param_vals)),
                        tuple((n if n is not None else s).detach()
                              for n, s in zip(new_states, state_vals)))

        class Traced(torch.nn.Module):
            def __init__(self, graph):
                super().__init__()
                self.graph_module = graph

            def forward(self, feed_vals, param_vals, state_vals):
                return self.graph_module(feed_vals, param_vals, state_vals)

        params = [p._value.detach() for _, p in param_items]
        states = [t._value.detach() for _, (t, *_r) in state_items]
        args = (tuple(self._example_feeds()), tuple(params), tuple(states))
        with export_scope():
            # traced below autograd first, so the backward's ops are plain
            # nodes: torch.export cannot follow every backward that
            # torch.autograd.grad runs inside it (a batched matmul's saved
            # views escape its tracer)
            graph = ex.make_fx(Step(), tracing_mode="fake",
                               _allow_non_fake_inputs=True)(*args)
            prog = ex.export(Traced(graph), args, strict=False)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        ex.save(prog, path + ".trainprogram")

        def sanitize(sp, cur):
            # a scheduler holding an unpicklable member (LambdaDecay's
            # lambda) is saved as its current learning rate
            if sp[0] == "lr":
                try:
                    pickle.dumps(sp[1])
                except Exception:
                    return ("lr", float(cur))
            return sp

        with open(path + ".trainstate", "wb") as f:
            pickle.dump({
                "params": [_numpy(v) for v in params],
                "param_names": [p.name for _, p in param_items],
                "states": [_numpy(v) for v in states],
                "state_specs": [sanitize(sp, v) for sp, v in
                                zip(specs, states)],
                "feed_names": [v.name for v in self.feed_vars],
                "n_fetch": len(fetch_list),
            }, f, protocol=4)


def _load_program(path, device):
    """A saved ``torch.export`` program, moved to ``device`` (every
    device it baked in at export included), as a callable."""
    ex = torch_export()
    prog = ex.move_to_device_pass(ex.load(path), device)
    return prog.module()


def _target(device) -> torch.device:
    from ..framework.place import to_device

    return to_device(device)


class LoadedTrainProgram:
    """A deserialized TRAINABLE program: holds the parameters and the
    optimizer state on its device; each ``run`` executes one train step
    and advances them (fresh-process resume, no model code needed)."""

    def __init__(self, path, device=None):
        self.device = _target(device)
        self._fn = _load_program(path + ".trainprogram", self.device)
        with open(path + ".trainstate", "rb") as f:
            meta = pickle.load(f)
        self.params = [torch.from_numpy(p).to(self.device)
                       for p in meta["params"]]
        self.param_names = meta["param_names"]
        self.states = [torch.from_numpy(np.asarray(s)).to(self.device)
                       for s in meta["states"]]
        self.state_specs = meta["state_specs"]
        self.feed_names = meta["feed_names"]
        self._n_fetch = meta["n_fetch"]

    def _refresh_states(self):
        out = []
        for v, (kind, arg) in zip(self.states, self.state_specs):
            if kind == "lr":
                lr = arg() if callable(arg) else arg
                out.append(torch.full_like(v, float(lr)))
            else:
                out.append(v)
        return out

    def run(self, feed: Dict[str, Any]):
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise KeyError(f"missing feeds {missing}")
        feeds = tuple(torch.as_tensor(np.asarray(feed[n])).to(self.device)
                      for n in self.feed_names)
        fetches, new_params, new_states = self._fn(
            feeds, tuple(self.params), tuple(self._refresh_states()))
        self.params = list(new_params)
        self.states = list(new_states)
        return [_numpy(o) for o in fetches]

    def state_dict(self):
        return {n: _numpy(p) for n, p in zip(self.param_names, self.params)}


def load_train_program(path, device=None) -> LoadedTrainProgram:
    return LoadedTrainProgram(path, device)


class LoadedProgram:
    """A deserialized static program (the inference replay) on
    ``device`` (the default place when None)."""

    def __init__(self, path, device=None):
        self.device = _target(device)
        self._fn = _load_program(path + ".program", self.device)
        with open(path + ".params", "rb") as f:
            meta = pickle.load(f)
        self._params = tuple(torch.from_numpy(p).to(self.device)
                             for p in meta["params"])
        self.feed_names = meta["feed_names"]
        self._n_fetch = meta["n_fetch"]

    def run(self, feed: Dict[str, Any]):
        feeds = tuple(torch.as_tensor(np.asarray(feed[n])).to(self.device)
                      for n in self.feed_names)
        with torch.no_grad():
            out = self._fn(feeds, self._params)
        return [_numpy(o) for o in out]


def load_inference_program(path, device=None) -> LoadedProgram:
    return LoadedProgram(path, device)


# --- default programs / guards ---------------------------------------------

_default_main = Program()
_default_startup = Program()
_RECORDING: List[Program] = []
_SUSPENDED = threading.local()


def _active_recorder() -> Optional[Program]:
    """The Program being built, if any (and recording is not
    suspended)."""
    if getattr(_SUSPENDED, "depth", 0):
        return None
    return _RECORDING[-1] if _RECORDING else None


@contextlib.contextmanager
def suspend_recording():
    """Pause op recording: a control-flow op records itself as ONE op,
    and its branch bodies must not append records of their own; a replay
    runs recorded functions without recording them again."""
    _SUSPENDED.depth = getattr(_SUSPENDED, "depth", 0) + 1
    try:
        yield
    finally:
        _SUSPENDED.depth -= 1


def default_main_program() -> Program:
    return _default_main


def default_startup_program() -> Program:
    return _default_startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _default_main, _default_startup
    prev_m, prev_s = _default_main, _default_startup
    _default_main = main_program
    if startup_program is not None:
        _default_startup = startup_program
    _RECORDING.append(main_program)
    try:
        yield
    finally:
        _RECORDING.pop()
        _default_main, _default_startup = prev_m, prev_s


class Scope:
    """Name → value map (reference scope.h:52): the parameters and the
    fetches of the last run, by name."""

    def __init__(self):
        self.vars = {}

    def var(self, name):
        return self.vars.setdefault(name, None)

    def find_var(self, name):
        return self.vars.get(name)

    def set(self, name, value):
        self.vars[name] = value


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = prev


def feed_placeholder(name, shape, dtype="float32", device=None):
    """A feed placeholder of the default main program on ``device`` (the
    default place when None)."""
    v = Variable(shape, dtype, name, device)
    _default_main.feed_vars.append(v)
    _default_main._slot(v)      # slot BEFORE any op consumes it
    return v


def data(name, shape, dtype="float32", lod_level=0):
    """Declare a feed placeholder (reference static/input.py data) of the
    default main program, on the default place (the card)."""
    return feed_placeholder(name, shape, dtype)


def _item_11(what):
    raise InvalidArgumentError(
        f"{what} is not ported: it is distributed training "
        "(ROADMAP queue 1 item 11)")


class CompiledProgram:
    """reference compiler.py:88.  The port replays a program eagerly on
    one device, so a CompiledProgram runs as its program; data
    parallelism over more than one device is item 11 and raises."""

    def __init__(self, program, build_strategy=None):
        self.program = program
        self._dp = False
        self._places = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        """Data parallelism over ``places``: one device runs as the
        program; more than one raises ``InvalidArgumentError``."""
        if places is not None and len(list(places)) > 1:
            _item_11("CompiledProgram.with_data_parallel over "
                     f"{len(list(places))} devices")
        self._dp = True
        self._places = places
        return self

    def feed_shardings(self, feed_vals):
        """One device: no feed is sharded (``None`` for each)."""
        return [None for _ in feed_vals]


class Executor:
    """reference fluid/executor.py:916 → executor.cc:166.

    ``run(program, feed, fetch_list)`` replays the recorded ops on the
    executor's device (``place``: None is the default place, the card),
    copies the updated parameters and state back in place and returns
    the fetches.  One replay is built per (program version, fetch list,
    feed signature)."""

    def __init__(self, place=None):
        from ..framework.place import to_device

        self.place = place
        dev = getattr(place, "torch_device", None)
        self._device = dev() if callable(dev) else to_device(place)
        self._cache = {}

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_names=None, return_numpy=True, scope=None,
            use_program_cache=True):
        from ..profiler.jit_cost import compile_ledger, cost_registry

        program = program or default_main_program()
        if isinstance(program, CompiledProgram):
            program = program.program
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        if not program.records:
            # the startup program: parameters were initialized eagerly
            # when the layers were built
            return [] if not fetch_list else [
                _numpy(f._value) if isinstance(f, Tensor) else None
                for f in fetch_list]

        feed_vals = []
        for v in program.feed_vars:
            if v.name not in feed:
                raise ValueError(
                    f"feed variable {v.name!r} was declared by the program "
                    f"but not fed (got feeds {sorted(feed)})")
            val = feed[v.name]
            t = (val._value if isinstance(val, Tensor)
                 else torch.as_tensor(np.asarray(val)))
            feed_vals.append(t.to(device=self._device,
                                  dtype=v._value.dtype))

        resolved = []
        for f in fetch_list:
            if isinstance(f, Tensor):
                resolved.append(f)
                continue
            name = str(f)
            found = None
            for v in program.feed_vars:
                if v.name == name:
                    found = v
            for rec in program.records:
                for t in rec.out_tensors:
                    if t is not None and t.name == name:
                        found = t
            if found is None:
                raise KeyError(
                    f"fetch target {name!r} not found in program "
                    f"(known feeds: {[v.name for v in program.feed_vars]})")
            resolved.append(found)
        fetch_list = resolved
        fetch_slots = tuple(program._fetch_slot(f) for f in fetch_list)
        sig = (id(program), program._version, fetch_slots,
               tuple((tuple(a.shape), str(a.dtype)) for a in feed_vals))
        entry = self._cache.get(sig)
        if entry is None:
            entry = program._replay_fn(list(fetch_slots))
            self._cache[sig] = entry
            key = str(sig[2:])
            compile_ledger.on_compile("static/executor", key)
            cost_registry.record_compile("static/executor", key, 0.0,
                                         False)
        run, param_items, state_items = entry

        param_vals = [p._value for _, p in param_items]
        state_vals = [(refresh() if refresh is not None else t._value)
                      for _, (t, _s, refresh, _spec) in state_items]
        fetches, new_params, new_states = run(feed_vals, param_vals,
                                              state_vals)
        _write_back(param_items, new_params, state_items, new_states)
        target = scope if scope is not None else global_scope()
        for _, p in param_items:
            if getattr(p, "name", None):
                target.set(p.name, p._value)
        for f, val in zip(fetch_list, fetches):
            if getattr(f, "name", None):
                target.set(f.name, val)
        if return_numpy:
            return [_numpy(o) for o in fetches]
        return [Tensor(o.detach()) for o in fetches]

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None):
        """The dataset-driven trainer (reference train_from_dataset →
        trainer.h:98 MultiTrainer) belongs to fleet: not ported."""
        _item_11("Executor.train_from_dataset (fleet's MultiTrainer)")

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None):
        _item_11("Executor.infer_from_dataset (fleet's MultiTrainer)")

    def close(self):
        pass


@torch.no_grad()
def _write_back(param_items, new_params, state_items, new_states):
    """Copy each updated parameter and state value into its tensor in
    place (the tensors the layer and the optimizer hold)."""
    from ..tensor import preserve_saved

    for (_, p), nv in zip(param_items, new_params):
        if nv is not None:
            preserve_saved(p._value)
            p._value.copy_(nv)
            p._inplace_version += 1
    for (_, (t, setter, _r, _spec)), nv in zip(state_items, new_states):
        if nv is None:
            continue
        if t._value.shape == nv.shape and t._value.dtype == nv.dtype:
            t._value.copy_(nv)
        else:
            t._value = nv.detach()
        if setter is not None:
            setter(t._value)
