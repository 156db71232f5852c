"""Functional execution of Layers — twin of
``paddle_tpu/jit/functional.py``.

``functional_call(layer, params, buffers, args)`` runs a Layer's forward
with the given tensors bound in place of its parameters and buffers, and
returns ``(outputs, new_buffers)``: the outputs as torch tensors, and
each buffer's tensor after the call.  ``bench.py``'s ``build_step`` and
the JAX package's ``hapi`` thread the training state through it.

It is a plain function over the port's ``Layer``, not ``torch.func``:
the bound tensors are swapped into the layers' ``Parameter``s and buffer
``Tensor``s for the call and the old ones put back after it.  Torch
autograd records the forward as it runs, so a gradient with respect to
the bound parameters is ``torch.autograd.grad(loss, params.values())``
(the JAX package takes ``jax.value_and_grad`` of the call and runs the
forward with its own tape off).  Where the JAX package returns new buffer
arrays, the port's layers update their buffers IN PLACE (a
``BatchNorm``'s running statistics, on the device): ``new_buffers[n]`` is
the tensor that was bound as ``buffers[n]``, holding its new value, so a
CUDA graph that captured the call updates the same storage at every
replay.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import torch

from ..tensor import Tensor

__all__ = ["get_state", "functional_call", "tree_unwrap", "tree_wrap"]


def tree_unwrap(obj):
    """``obj`` with every Tensor replaced by its torch tensor."""
    if isinstance(obj, Tensor):
        return obj._value
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_unwrap(o) for o in obj)
    if isinstance(obj, dict):
        return {k: tree_unwrap(v) for k, v in obj.items()}
    return obj


def tree_wrap(obj):
    """``obj`` with every torch tensor wrapped as a Tensor."""
    if isinstance(obj, torch.Tensor):
        return Tensor(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_wrap(o) for o in obj)
    if isinstance(obj, dict):
        return {k: tree_wrap(v) for k, v in obj.items()}
    return obj


def get_state(layer) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``({name: parameter tensor}, {name: buffer tensor})`` — the
    layer's own torch tensors, not copies."""
    params = {n: p._value for n, p in layer.named_parameters()}
    buffers = {n: b._value for n, b in layer.named_buffers()}
    return params, buffers


_bind_lock = threading.RLock()


def functional_call(layer, params: Dict[str, Any], buffers: Dict[str, Any],
                    args=(), kwargs=None, training: Optional[bool] = None):
    """Run ``layer.forward`` with ``params`` and
    ``buffers`` bound by name (names missing from them keep the layer's
    own tensors) and, when ``training`` is given, every sublayer in that
    mode.  Returns ``(output tree of torch tensors, {name: buffer
    tensor})``; the layer's own tensors and modes are restored after."""
    kwargs = kwargs or {}
    param_objs = dict(layer.named_parameters())
    buffer_objs = dict(layer.named_buffers())
    with _bind_lock:
        old_params = {n: p._value for n, p in param_objs.items()}
        old_bufs = {n: b._value for n, b in buffer_objs.items()}
        old_training = [(sub, sub.training)
                        for sub in layer.sublayers(include_self=True)]
        try:
            for n, p in param_objs.items():
                if n in params:
                    p._value = params[n]
            for n, b in buffer_objs.items():
                if n in buffers:
                    b._value = buffers[n]
            if training is not None:
                for sub, _ in old_training:
                    sub.training = training
            wrapped = [Tensor(a) if isinstance(a, torch.Tensor) else a
                       for a in args]
            out = tree_unwrap(layer.forward(*wrapped, **kwargs))
            new_buffers = {n: b._value for n, b in buffer_objs.items()}
        finally:
            for n, p in param_objs.items():
                p._value = old_params[n]
            for n, b in buffer_objs.items():
                b._value = old_bufs[n]
            for sub, mode in old_training:
                sub.training = mode
    return out, new_buffers
