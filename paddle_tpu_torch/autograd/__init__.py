"""Grad-mode switches and the functional autograd API — twins of
``paddle_tpu/autograd``'s ``no_grad``, ``enable_grad``,
``set_grad_enabled``, ``is_grad_enabled``, ``backward`` and ``grad``,
over torch autograd (the JAX tape is not re-implemented: torch records
the graph).  ``no_grad``/``enable_grad`` work as context managers and
decorators.  ``backward`` and ``grad`` consume the graphs they run
through unless ``retain_graph`` (``Optimizer.minimize`` then skips its
backward), as the reference's engine releases them.

``run_backward`` is the reference engine's entry
(``paddle_tpu/autograd/tape.py:155``) over ``torch.autograd``: into the
leaves' ``grad`` (accumulated, or replaced with ``accumulate=False``), or,
with ``inputs``, returned as ``paddle.grad`` returns them.  ``GradNode``
is a read-only view of the torch node that made a Tensor."""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "backward", "grad", "run_backward", "GradNode"]

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


def _leaves(outs):
    """The leaf torch tensors the graphs of ``outs`` accumulate into."""
    found = [o for o in outs if o.grad_fn is None and o.requires_grad]
    # the visited nodes are held: a node's Python object lives only while
    # referenced, so an id() could be a dead one's
    seen, held = set(), []
    stack = [o.grad_fn for o in outs if o.grad_fn is not None]
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        held.append(node)
        var = getattr(node, "variable", None)
        if var is not None:
            found.append(var)
        stack += [n for n, _ in node.next_functions]
    return found


def run_backward(tensors, grad_tensors=None, retain_graph=False,
                 create_graph=False, inputs=None, allow_unused=False,
                 accumulate=True):
    """The reverse walk from ``tensors``, seeded with ``grad_tensors``
    (an implicit seed needs a one-element output).  Without ``inputs``
    the gradients go into every leaf's ``grad`` (added to it, or in its
    place with ``accumulate=False``); with ``inputs`` they are returned
    as a list and no ``grad`` changes (None for an input the outputs do
    not reach, which needs ``allow_unused``)."""
    from ..tensor import Tensor, _mark_consumed, _unwrap

    outs = [_unwrap(t) for t in _as_list(tensors)]
    given = _as_list(grad_tensors) or [None] * len(outs)
    for o, g in zip(outs, given):
        if g is None and o.numel() != 1:
            raise RuntimeError(
                "grad can be implicitly created only for scalar outputs; "
                f"got shape {list(o.shape)}")
    seeds = _seeds(outs, given)
    if inputs is not None:
        ins = [_unwrap(t) for t in _as_list(inputs)]
        gs = torch.autograd.grad(outs, ins, seeds, retain_graph=retain_graph,
                                 create_graph=create_graph, allow_unused=True)
        if not allow_unused and any(g is None for g in gs):
            raise RuntimeError(
                "one of the input tensors was not used in the graph; set "
                "allow_unused=True to return None for it")
        _mark_consumed(outs, retain_graph)
        return [None if g is None else Tensor(g) for g in gs]
    if not accumulate:
        for leaf in _leaves(outs):
            leaf.grad = None
    torch.autograd.backward(outs, seeds, retain_graph=retain_graph,
                            create_graph=create_graph)
    _mark_consumed(outs, retain_graph)
    return None


class GradNode:
    """A read-only view of the torch autograd node behind a Tensor (or of
    a torch node): ``name`` (the node's class, ``"MulBackward0"``),
    ``edges`` (the views of the nodes of its inputs, None where an input
    needs no gradient) and ``release()``, which drops the view's hold of
    the node (torch frees the node's buffers when its backward runs
    without ``retain_graph``)."""

    def __init__(self, node):
        from ..tensor import Tensor

        if isinstance(node, Tensor):
            node = node._value.grad_fn
        elif isinstance(node, torch.Tensor):
            node = node.grad_fn
        self._node = node

    @property
    def name(self):
        return None if self._node is None else self._node.name()

    @property
    def edges(self):
        if self._node is None:
            return []
        return [None if n is None else GradNode(n)
                for n, _ in self._node.next_functions]

    def release(self):
        self._node = None

    def __repr__(self):
        return f"GradNode({self.name})"
