"""Creation ops — twin of ``paddle_tpu/ops/creation.py``.

A new tensor lies on the default place (``framework.place``); one made
``_like`` another lies where that one does.  Without a ``dtype`` the
floating ops take the default dtype (float32 until
``set_default_dtype``), ``full`` included, and ``arange`` of integral
bounds is int64, as paddle's (the JAX package narrows int64 to int32
while JAX's 64-bit mode is off).  ``empty`` is ``zeros``, as in the
reference."""
from __future__ import annotations

import torch

from ..framework.dtype import convert_dtype, get_default_dtype
from ..framework.place import default_device
from ..tensor import Parameter, Tensor, to_tensor  # noqa: F401
from ._helpers import norm_shape, resolve_dtype, to_tensor_like, value_of
from .dispatch import apply

__all__ = ["to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
           "full_like", "empty", "empty_like", "arange", "linspace",
           "logspace", "eye", "diag", "diagflat", "tril", "triu",
           "meshgrid", "assign", "clone", "numel", "create_parameter"]


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    return Tensor(torch.full(norm_shape(shape), value_of(fill_value),
                             dtype=resolve_dtype(dtype),
                             device=default_device()))


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


def ones_like(x, dtype=None, name=None) -> Tensor:
    return full_like(x, 1, dtype)


def empty(shape, dtype=None, name=None) -> Tensor:
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None) -> Tensor:
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    """``[start, end)`` by ``step`` (``arange(n)`` is ``[0, n)``); int64
    when every bound is integral and no dtype is given, else the default
    dtype."""
    start, end, step = value_of(start), value_of(end), value_of(step)
    if end is None:
        start, end = 0, start
    start, end, step = (v.item() if isinstance(v, torch.Tensor) else v
                        for v in (start, end, step))
    if dtype is None:
        integral = all(float(v) == int(v) for v in (start, end, step))
        d = torch.int64 if integral else get_default_dtype()
    else:
        d = convert_dtype(dtype)
    return Tensor(torch.arange(start, end, step, dtype=d,
                               device=default_device()))


def linspace(start, stop, num, dtype=None, name=None) -> Tensor:
    return Tensor(torch.linspace(float(value_of(start)),
                                 float(value_of(stop)), int(num),
                                 dtype=resolve_dtype(dtype),
                                 device=default_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None) -> Tensor:
    return Tensor(torch.logspace(float(value_of(start)),
                                 float(value_of(stop)), int(num), base=base,
                                 dtype=resolve_dtype(dtype),
                                 device=default_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None) -> Tensor:
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return Tensor(torch.eye(n, m, dtype=resolve_dtype(dtype),
                            device=default_device()))


def diag(x, offset=0, padding_value=0, name=None) -> Tensor:
    """A 1-D x on the ``offset`` diagonal of a square matrix filled with
    ``padding_value``; the ``offset`` diagonal of a 2-D x."""
    x = to_tensor_like(x)
    if x.ndim == 1 and padding_value != 0:
        def f(v):
            d = torch.diag(v, offset)
            mask = torch.diag(torch.ones_like(v, dtype=torch.bool), offset)
            return torch.where(mask, d, torch.full_like(d, padding_value))

        return apply("diag", f, x)
    return apply("diag", lambda v: torch.diag(v, offset), x)


def diagflat(x, offset=0, name=None) -> Tensor:
    return apply("diagflat", lambda v: torch.diagflat(v, offset),
                 to_tensor_like(x))


def tril(x, diagonal=0, name=None) -> Tensor:
    return apply("tril", lambda v: torch.tril(v, diagonal),
                 to_tensor_like(x))


def triu(x, diagonal=0, name=None) -> Tensor:
    return apply("triu", lambda v: torch.triu(v, diagonal),
                 to_tensor_like(x))


def meshgrid(*args, **kwargs):
    """Coordinate grids of 1-D tensors, "ij" indexing; a list."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    ts = [to_tensor_like(a) for a in args]
    return list(apply("meshgrid", lambda *vs: tuple(
        torch.meshgrid(*vs, indexing="ij")), *ts))


def assign(x, output=None) -> Tensor:
    """A copy of x (into ``output`` when given)."""
    out = apply("assign", lambda v: v.clone(), to_tensor_like(x))
    if output is not None:
        return output._replace_from(out)
    return out


def clone(x) -> Tensor:
    return to_tensor_like(x).clone()


def numel(x) -> Tensor:
    """The element count as a 0-d int64 tensor on x's device."""
    x = to_tensor_like(x)
    return Tensor(torch.full((), x.size, dtype=torch.int64,
                             device=x._value.device))


def create_parameter(shape, dtype=None, name=None, attr=None, is_bias=False,
                     default_initializer=None) -> Parameter:
    """A Parameter on the default place, set up as ``nn.Layer.
    create_parameter`` sets one up (``ParamAttr`` included)."""
    from ..nn.layer import make_parameter

    return make_parameter(shape, resolve_dtype(dtype), attr, is_bias,
                          default_initializer, name=name)
