"""Grad-mode switches and the functional autograd API — twins of
``paddle_tpu/autograd``'s ``no_grad``, ``enable_grad``,
``set_grad_enabled``, ``is_grad_enabled``, ``backward`` and ``grad``,
over torch autograd (the JAX tape is not re-implemented: torch records
the graph).  ``no_grad``/``enable_grad`` work as context managers and
decorators.  ``backward`` and ``grad`` consume the graphs they run
through unless ``retain_graph`` (``Optimizer.minimize`` then skips its
backward), as the reference's engine releases them.  ``GradNode`` and
``run_backward`` wait for ROADMAP step E2."""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "backward", "grad"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def _as_list(x):
    if x is None:
        return None
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _seeds(outs, grads):
    """The seed gradient of each output: the given one, else ones (as
    paddle seeds a non-scalar output too)."""
    from ..tensor import Tensor

    grads = grads or [None] * len(outs)
    return [torch.ones_like(o) if g is None else
            (g._value if isinstance(g, Tensor) else torch.as_tensor(
                g, device=o.device)) for o, g in zip(outs, grads)]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` (seeded with
    ``grad_tensors``, else ones) into every leaf that requires grad."""
    from ..tensor import _mark_consumed, _unwrap

    outs = [_unwrap(t) for t in _as_list(tensors)]
    torch.autograd.backward(outs, _seeds(outs, _as_list(grad_tensors)),
                            retain_graph=retain_graph)
    _mark_consumed(outs, retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """The gradients of ``outputs`` with respect to ``inputs`` as a list
    of Tensors (None for an input the outputs do not reach, which needs
    ``allow_unused``); ``create_graph`` records them for a second
    derivative.  ``retain_graph`` defaults to ``create_graph``."""
    from ..tensor import Tensor, _mark_consumed, _unwrap

    outs = [_unwrap(t) for t in _as_list(outputs)]
    ins = [_unwrap(t) for t in _as_list(inputs)]
    if retain_graph is None:
        retain_graph = create_graph
    gs = torch.autograd.grad(outs, ins,
                             _seeds(outs, _as_list(grad_outputs)),
                             retain_graph=retain_graph,
                             create_graph=create_graph,
                             allow_unused=allow_unused)
    _mark_consumed(outs, retain_graph)
    return [None if g is None else Tensor(g) for g in gs]
