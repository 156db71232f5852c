"""Tensor — twin of ``paddle_tpu/tensor.py``: the paddle eager tensor
over a torch tensor.

``_value`` is the torch tensor.  Autograd is torch's: a leaf with
``stop_gradient=False`` is a torch leaf that requires grad, an op's
output carries its ``grad_fn``.  Paddle's semantics on top:

- ``stop_gradient`` (default True) is the inverse of ``requires_grad``;
  setting it True on an op's output cuts the graph there (detach);
- ``grad`` is a Tensor or None; grads accumulate over backward calls
  until ``clear_grad``, which sets them to None; a non-leaf keeps its
  grad only after ``retain_grads()``;
- ``shape`` is a list; ``dtype`` is the torch dtype (``str`` of it ends
  in the paddle name, ``"torch.bfloat16"``).

Every operator goes through ``ops.dispatch.apply`` under paddle_tpu's op
names, so AMP, the NaN/Inf sweep and the operator error prefix apply."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .framework.dtype import convert_dtype, is_floating

__all__ = ["Tensor", "Parameter", "to_tensor"]


class Tensor:
    __slots__ = ("_value", "name", "__weakref__")

    def __init__(self, value, stop_gradient: bool = True,
                 name: Optional[str] = None):
        if isinstance(value, Tensor):
            value = value._value
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        self._value = value
        if not stop_gradient:
            self.stop_gradient = False
        self.name = name

    # --- metadata -----------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return not self._value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        v = self._value
        if value:
            if v.grad_fn is not None:
                self._value = v.detach()
            else:
                v.requires_grad_(False)
        elif v.grad_fn is None and is_floating(v.dtype):
            v.requires_grad_(True)

    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def size(self):
        return self._value.numel()

    @property
    def dtype(self) -> torch.dtype:
        return self._value.dtype

    @property
    def place(self) -> torch.device:
        return self._value.device

    @property
    def is_leaf(self) -> bool:
        return self._value.grad_fn is None

    @property
    def grad(self) -> Optional["Tensor"]:
        v = self._value
        if not (v.is_leaf or v.retains_grad):
            return None
        return None if v.grad is None else Tensor(v.grad)

    # --- host interop -------------------------------------------------
    def numpy(self):
        """A copy of the value as a numpy array (bf16 as float32): later
        in-place updates of the tensor do not reach it."""
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            return v.float().cpu().numpy()
        if v.device.type != "cpu":
            return v.cpu().numpy()
        return v.numpy().copy()

    def item(self, *args):
        return self.numpy().item(*args)

    def __float__(self):
        return float(self.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, idx) -> "Tensor":
        """Indexing as torch's (ints, slices, None, ``...``, integer or
        bool Tensors), dispatched as "slice"."""
        from .ops.dispatch import apply

        cidx = _clean_index(idx)
        return apply("slice", lambda v: v[cidx], self)

    # --- autograd -----------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        """Accumulate d(self)/d(leaf) into every leaf that requires grad
        (ones as the seed gradient, as paddle, also for a non-scalar)."""
        if grad_tensor is None:
            grad = torch.ones_like(self._value)
        else:
            grad = (grad_tensor._value if isinstance(grad_tensor, Tensor)
                    else torch.as_tensor(grad_tensor,
                                         device=self._value.device))
        torch.autograd.backward(self._value, grad, retain_graph=retain_graph)

    def retain_grads(self):
        self._value.retain_grad()

    def clear_grad(self):
        self._value.grad = None

    def detach(self) -> "Tensor":
        return Tensor(self._value.detach())

    # --- ops ----------------------------------------------------------
    def astype(self, dtype) -> "Tensor":
        from .ops.dispatch import apply

        d = convert_dtype(dtype)
        return apply("cast", lambda x: x.to(d), self)

    cast = astype

    def reshape(self, shape, name=None) -> "Tensor":
        from .ops.manipulation import reshape

        return reshape(self, shape)

    def transpose(self, perm=None, name=None) -> "Tensor":
        from .ops.manipulation import transpose

        return transpose(self, perm)

    def t(self, name=None) -> "Tensor":
        """The transpose of a tensor of at most 2 axes (paddle.t)."""
        from .ops.dispatch import apply

        if self.ndim > 2:
            raise ValueError("paddle.t only supports ndim <= 2")
        return apply("t", lambda v: v.t(), self)

    def squeeze(self, axis=None, name=None) -> "Tensor":
        from .ops.manipulation import squeeze

        return squeeze(self, axis)

    def unsqueeze(self, axis, name=None) -> "Tensor":
        from .ops.manipulation import unsqueeze

        return unsqueeze(self, axis)

    def sum(self, axis=None, dtype=None, keepdim=False, name=None):
        from .ops.dispatch import apply

        dims = _dims(axis)
        d = convert_dtype(dtype) if dtype is not None else None
        return apply("reduce_sum", lambda v: torch.sum(
            v, dim=dims, keepdim=keepdim, dtype=d), self)

    def mean(self, axis=None, keepdim=False, name=None):
        from .ops.dispatch import apply

        dims = _dims(axis)
        return apply("reduce_mean", lambda v: torch.mean(
            v, dim=dims, keepdim=keepdim), self)

    def __repr__(self):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}, "
                f"place={self.place}{grad_info},\n       "
                f"{self.numpy()!r})")

    __str__ = __repr__


def _clean_index(idx):
    """An index with its Tensors unwrapped to their torch values."""
    if isinstance(idx, tuple):
        return tuple(_clean_index(i) for i in idx)
    return idx._value if isinstance(idx, Tensor) else idx


def _dims(axis):
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _binary(name, fn, reverse=False):
    def method(self, other):
        from .ops.dispatch import apply

        if reverse:
            return apply(name, lambda b, a: fn(a, b), self, other)
        return apply(name, fn, self, other)

    return method


def _unary(name, fn):
    def method(self):
        from .ops.dispatch import apply

        return apply(name, fn, self)

    return method


for _op, _fn in {
    "__add__": torch.add,
    "__sub__": torch.sub,
    "__mul__": torch.mul,
    "__truediv__": torch.true_divide,
    "__pow__": torch.pow,
    "__matmul__": torch.matmul,
}.items():
    setattr(Tensor, _op, _binary(_op.strip("_"), _fn))
    _rop = "__r" + _op[2:]
    setattr(Tensor, _rop, _binary(_rop.strip("_"), _fn, reverse=True))

Tensor.__neg__ = _unary("neg", torch.neg)


class Parameter(Tensor):
    """A trainable leaf (paddle's ParamBase): ``stop_gradient`` is
    ``not trainable``."""

    __slots__ = ("trainable",)

    def __init__(self, value, name=None, trainable=True):
        if isinstance(value, Tensor):
            value = value._value
        super().__init__(torch.as_tensor(value).detach(),
                         stop_gradient=not trainable, name=name)
        self.trainable = trainable


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """Twin of ``paddle_tpu/ops/creation.py:28``: a new leaf on ``place``
    (the default place when None), copied from a list, a numpy array, a
    torch tensor or a Tensor.  float64 data becomes float32 unless
    ``dtype`` says otherwise (paddle's default dtype)."""
    from .framework.place import to_device

    dev = to_device(place)
    if isinstance(data, Tensor):
        data = data._value
    if isinstance(data, torch.Tensor):
        v = data.detach().clone()
    else:
        arr = np.array(data, copy=True)
        if arr.dtype == np.float64 and dtype is None:
            arr = arr.astype(np.float32)
        v = torch.from_numpy(arr)
    if dtype is not None:
        v = v.to(convert_dtype(dtype))
    return Tensor(v.to(dev), stop_gradient=stop_gradient)
