"""Argument helpers of the dygraph ops — twins of
``paddle_tpu/ops/_helpers.py``'s ``to_tensor_like``, ``norm_axis``,
``norm_shape`` and ``resolve_dtype``."""
from __future__ import annotations

import numbers

import numpy as np
import torch

__all__ = ["to_tensor_like", "operand", "binary_op", "norm_axis",
           "norm_shape", "value_of", "resolve_dtype"]


def to_tensor_like(x, like=None):
    """``x`` as a Tensor: a Tensor as it is, a torch tensor wrapped where
    it lies, anything else copied to ``like``'s device (a Tensor), or to
    the default place."""
    from ..tensor import Tensor, to_tensor

    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return Tensor(x)
    place = like._value.device if isinstance(like, Tensor) else None
    return to_tensor(np.asarray(x), place=place)


def operand(x, like):
    """An operand of a binary op beside the Tensor ``like``: a Python
    number stays one (a torch scalar operand, weakly typed as JAX's, and
    no host-to-device copy); anything else as :func:`to_tensor_like`
    on ``like``'s device."""
    if isinstance(x, numbers.Number) and not isinstance(x, np.generic):
        return x
    return to_tensor_like(x, like)


def binary_op(op_name, fn):
    """The paddle op ``op_name(x, y)`` over ``fn``, dispatched as
    ``op_name``: either operand may be a Python number (see
    :func:`operand`), the other is made a Tensor on its device."""
    from ..tensor import Tensor
    from .dispatch import apply

    def op(x, y, name=None):
        if isinstance(x, Tensor) or not isinstance(y, Tensor):
            x = to_tensor_like(x)
            return apply(op_name, fn, x, operand(y, x))
        return apply(op_name, fn, operand(x, y), y)

    op.__name__ = op_name
    return op


def value_of(x):
    from ..tensor import Tensor

    return x._value if isinstance(x, Tensor) else x


def norm_axis(axis):
    """Paddle's axis: an int, a list or tuple of ints, a Tensor, or None."""
    from ..tensor import Tensor

    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    if isinstance(axis, Tensor):
        return tuple(int(v) for v in axis.numpy().reshape(-1))
    return int(axis)


def norm_shape(shape):
    """Paddle's shape: an int, a list or tuple of ints or 0-d Tensors, or
    a Tensor."""
    from ..tensor import Tensor

    if isinstance(shape, Tensor):
        return tuple(int(v) for v in shape.numpy().reshape(-1))
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def resolve_dtype(dtype, default=None):
    """``dtype`` as a torch dtype; None is ``default``, else the default
    dtype (``framework.dtype.get_default_dtype``)."""
    from ..framework import dtype as _dt

    if dtype is None:
        return default if default is not None else _dt.get_default_dtype()
    return _dt.convert_dtype(dtype)
