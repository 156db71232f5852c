"""``@to_static`` — twin of ``paddle_tpu/jit/to_static.py`` (reference:
paddle.jit.to_static / @declarative, fluid/dygraph/jit.py:160 +
dygraph_to_static/program_translator.py:233 StaticFunction).

The callable first goes through the dy2static AST pass
(``jit/dy2static.py``): Python ``if`` / ``while`` / ``for range()`` over
tensor values is rewritten onto ``jit.control_flow``.  Where the JAX
package then traces one XLA computation per (shapes, dtypes, training)
signature, the port runs each signature eagerly on the card, op by op
through the same kernels as the dygraph forward (attention on the flash
kernels at S >= 128) — a CUDA graph of it is a speed change, ROADMAP
step B.  Each new signature is one entry of ``concrete_programs`` and
one compile of ``jit/to_static:<name>`` in
``profiler.jit_cost.compile_ledger``, as the port's other programs are
counted.

A run is a capture in the JAX package's sense: a Tensor refuses
``bool``/``int``/``float`` coercion inside it
(``framework.export_compat.capturing``), so control flow the AST pass
left alone fails loudly instead of running one branch.  Converted
control flow reads its predicate to the host once.

A Layer's forward runs on the Layer's own parameters, so ``backward()``
reaches them, and its buffers (a batch norm's running statistics) are
updated in place by the layers themselves — the JAX package writes its
traced buffers back (``:130-136``).  Under ``torch.export``
(``jit.save``) or while a static Program records, the function runs as
it is, without the signature cache.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from ..framework.export_compat import capture_scope, exporting, \
    is_placeholder
from ..tensor import Tensor

__all__ = ["InputSpec", "StaticFunction", "to_static", "declarative",
           "not_to_static"]


class InputSpec:
    """paddle.static.InputSpec parity: a shape (``None``/-1 for a dim
    not fixed), a dtype and a name."""

    def __init__(self, shape, dtype="float32", name=None):
        from ..framework import dtype as _dt

        self.shape = tuple(shape)
        self.dtype = _dt.convert_dtype(dtype)
        self.name = name

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def _sig_of(args):
    sig = []
    for a in args:
        if isinstance(a, Tensor):
            sig.append(("T", tuple(a._value.shape), str(a._value.dtype)))
        elif isinstance(a, (np.ndarray, torch.Tensor)):
            sig.append(("A", tuple(a.shape), str(a.dtype)))
        else:
            sig.append(("S", repr(a)))
    return tuple(sig)


class ConcreteProgram:
    """One signature of a StaticFunction: its key and the number of
    runs."""

    def __init__(self, signature, training):
        self.signature = signature
        self.training = training
        self.runs = 0

    def __repr__(self):
        return (f"ConcreteProgram(signature={self.signature}, "
                f"training={self.training}, runs={self.runs})")


class StaticFunction:
    """A converted callable over a Layer's forward or a free function,
    with one ConcreteProgram per input signature."""

    def __init__(self, function, input_spec=None, layer=None):
        self._fn = function
        self._layer = layer
        self._input_spec = input_spec
        self._cache: Dict[Any, ConcreteProgram] = {}
        functools.update_wrapper(self, function)

    @property
    def concrete_programs(self):
        return list(self._cache.values())

    def _device(self):
        if self._layer is not None:
            for p in self._layer.parameters():
                return p._value.device
        from ..framework.place import default_device

        return default_device()

    def __call__(self, *args, **kwargs):
        from ..ops.dispatch import _recording_program
        from ..profiler.jit_cost import compile_ledger, cost_registry

        vals = [a._value for a in args if isinstance(a, Tensor)]
        if exporting() or _recording_program() is not None or any(
                is_placeholder(v) for v in vals):
            return self._fn(*args, **kwargs)
        dev = None
        conv = []
        for a in args:
            if isinstance(a, np.ndarray):
                dev = dev or self._device()
                a = Tensor(torch.from_numpy(np.array(a, copy=True)).to(dev))
            elif isinstance(a, torch.Tensor):
                a = Tensor(a)
            conv.append(a)
        training = self._layer.training if self._layer is not None else None
        sig = (_sig_of(conv), tuple(sorted(
            (k, repr(v)) for k, v in kwargs.items())), training)
        entry = self._cache.get(sig)
        if entry is None:
            entry = self._cache[sig] = ConcreteProgram(sig, training)
            name = "jit/to_static:" + getattr(self._fn, "__qualname__",
                                              type(self._fn).__name__)
            compile_ledger.on_compile(name, str(sig))
            cost_registry.record_compile(name, str(sig), 0.0, False)
        entry.runs += 1
        with capture_scope():
            return self._fn(*conv, **kwargs)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None):
    """Decorator / wrapper: the dy2static AST pass, then a
    StaticFunction.  A Layer gets its ``forward`` replaced (and is
    returned); a bound method keeps its instance; anything out of the
    AST pass's subset is left as it is and keeps the loud capture-time
    error."""
    import inspect
    import types

    from ..nn.layer import Layer
    from .dy2static import convert_function

    def decorate(obj):
        if getattr(obj, "_not_to_static", False):
            return obj
        if isinstance(obj, Layer):
            fwd = obj.forward
            if isinstance(fwd, StaticFunction):
                return obj
            func = fwd.__func__ if inspect.ismethod(fwd) else fwd
            conv, did = convert_function(func)
            if did and inspect.ismethod(fwd):
                fwd = types.MethodType(conv, obj)
            elif did:
                fwd = conv
            obj.forward = StaticFunction(fwd, input_spec, layer=obj)
            return obj
        if inspect.ismethod(obj):
            conv, did = convert_function(obj.__func__)
            bound = types.MethodType(conv, obj.__self__) if did else obj
            return StaticFunction(bound, input_spec,
                                  layer=obj.__self__ if isinstance(
                                      obj.__self__, Layer) else None)
        conv, _ = convert_function(obj)
        return StaticFunction(conv, input_spec)

    if function is not None:
        return decorate(function)
    return decorate


declarative = to_static


def not_to_static(fn):
    """Mark ``fn`` to stay dygraph: ``to_static`` returns it as it is."""
    fn._not_to_static = True
    return fn
