"""Argument helpers of the dygraph ops — twins of
``paddle_tpu/ops/_helpers.py``'s ``to_tensor_like``, ``norm_axis`` and
``norm_shape``."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_tensor_like", "norm_axis", "norm_shape", "value_of"]


def to_tensor_like(x):
    """``x`` as a Tensor: a Tensor as it is, a torch tensor wrapped where
    it lies, anything else copied to the default place."""
    from ..tensor import Tensor, to_tensor

    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return Tensor(x)
    return to_tensor(np.asarray(x))


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
