"""Creation ops — twins of ``paddle_tpu/ops/creation.py``'s ``zeros``,
``ones``, ``full``, ``arange``, ``zeros_like`` and ``full_like``.

A new tensor lies on the default place (``framework.place``); one made
``_like`` another lies where that one does.  The default dtype is
float32, and ``arange`` of integers is int64, as paddle's (the JAX
package narrows int64 to int32 while JAX's x64 mode is off)."""
from __future__ import annotations

import torch

from ..framework.dtype import convert_dtype
from ..framework.place import default_device
from ..tensor import Tensor
from ._helpers import norm_shape, to_tensor_like, value_of

__all__ = ["zeros", "ones", "full", "arange", "zeros_like", "full_like"]


def _dtype(dtype):
    return torch.float32 if dtype is None else convert_dtype(dtype)


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    return Tensor(torch.full(norm_shape(shape), value_of(fill_value),
                             dtype=_dtype(dtype), device=default_device()))


def zeros(shape, dtype=None, name=None) -> Tensor:
    return full(shape, 0, dtype)


def ones(shape, dtype=None, name=None) -> Tensor:
    return full(shape, 1, dtype)


def full_like(x, fill_value, dtype=None, name=None) -> Tensor:
    v = to_tensor_like(x)._value
    d = v.dtype if dtype is None else convert_dtype(dtype)
    return Tensor(torch.full(v.shape, value_of(fill_value), dtype=d,
                             device=v.device))


def zeros_like(x, dtype=None, name=None) -> Tensor:
    return full_like(x, 0, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    """``[start, end)`` by ``step`` (``arange(n)`` is ``[0, n)``); int64
    when every bound is integral and no dtype is given, else float32."""
    start, end, step = value_of(start), value_of(end), value_of(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        integral = all(float(v) == int(v) for v in (start, end, step))
        d = torch.int64 if integral else torch.float32
    else:
        d = convert_dtype(dtype)
    return Tensor(torch.arange(start, end, step, dtype=d,
                               device=default_device()))
