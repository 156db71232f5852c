"""Comparison and logical ops — twin of ``paddle_tpu/ops/logic.py``.

``cond`` is ``jit.control_flow.cond``."""
from __future__ import annotations

import torch

from ..tensor import Tensor
from ._helpers import binary_op, operand, to_tensor_like
from .dispatch import apply

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
           "logical_not", "bitwise_not", "is_empty", "is_tensor", "where",
           "cond"]


equal = binary_op("equal", torch.eq)
not_equal = binary_op("not_equal", torch.ne)
greater_than = binary_op("greater_than", torch.gt)
greater_equal = binary_op("greater_equal", torch.ge)
less_than = binary_op("less_than", torch.lt)
less_equal = binary_op("less_equal", torch.le)
logical_and = binary_op("logical_and", torch.logical_and)
logical_or = binary_op("logical_or", torch.logical_or)
logical_xor = binary_op("logical_xor", torch.logical_xor)
bitwise_and = binary_op("bitwise_and", torch.bitwise_and)
bitwise_or = binary_op("bitwise_or", torch.bitwise_or)
bitwise_xor = binary_op("bitwise_xor", torch.bitwise_xor)


def logical_not(x, name=None):
    return apply("logical_not", torch.logical_not, to_tensor_like(x))


def bitwise_not(x, name=None):
    return apply("bitwise_not", torch.bitwise_not, to_tensor_like(x))


def is_empty(x, name=None):
    """A 0-d bool tensor on x's device: whether x has no element."""
    x = to_tensor_like(x)
    return Tensor(torch.full((), x.size == 0, dtype=torch.bool,
                             device=x._value.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y``; with neither, the
    indices of the true entries (``nonzero(as_tuple=True)``)."""
    condition = to_tensor_like(condition)
    if x is None and y is None:
        from .search import nonzero

        return nonzero(condition, as_tuple=True)
    return apply("where", lambda c, a, b: torch.where(c.bool(), a, b),
                 condition, operand(x, condition), operand(y, condition))


def cond(pred, true_fn, false_fn, name=None):
    """``jit.control_flow.cond``: ``true_fn()`` or ``false_fn()`` as the
    one-element predicate, read to the host once, says (also inside
    ``jit.to_static``); ``torch.cond`` under ``torch.export``; refused
    while a static Program records (use ``traced_cond`` there)."""
    from ..jit import control_flow

    return control_flow.cond(to_tensor_like(pred), true_fn, false_fn)
