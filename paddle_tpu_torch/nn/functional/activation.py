"""Activations — twins of ``paddle_tpu/nn/functional/activation.py``'s
``relu``, ``sigmoid``, ``tanh``, ``softmax``, ``log_softmax`` and
``gelu``, dispatched under the same op names.

``gelu`` also takes a plain torch tensor and returns one: the torch-module
``GPTModel`` (``text/models.py``) calls it so."""
from __future__ import annotations

import torch

from ...framework.dtype import convert_dtype
from ...ops._helpers import to_tensor_like
from ...ops.dispatch import apply

__all__ = ["relu", "sigmoid", "tanh", "softmax", "log_softmax", "gelu"]


def _unop(op_name, fn):
    def op(x, name=None):
        return apply(op_name, fn, to_tensor_like(x))

    op.__name__ = op_name
    return op


relu = _unop("relu", torch.relu)
sigmoid = _unop("sigmoid", torch.sigmoid)
tanh = _unop("tanh", torch.tanh)


def softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype) if dtype is not None else None
    return apply("softmax", lambda v: torch.softmax(
        v if d is None else v.to(d), dim=axis), to_tensor_like(x))


def log_softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype) if dtype is not None else None
    return apply("log_softmax", lambda v: torch.log_softmax(
        v if d is None else v.to(d), dim=axis), to_tensor_like(x))


def gelu(x, approximate=False, name=None):
    """Exact GELU (erf form); the tanh approximation is not ported."""
    from ...text.generation import _gelu

    if approximate:
        from ...framework.errors import InvalidArgumentError

        raise InvalidArgumentError(
            "gelu(approximate=True) is not ported yet (ROADMAP queue 1 "
            "item 8)")
    if isinstance(x, torch.Tensor):
        return _gelu(x)
    return apply("gelu", _gelu, to_tensor_like(x))
