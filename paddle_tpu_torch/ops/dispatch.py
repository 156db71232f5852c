"""The eager op dispatcher — twin of ``paddle_tpu/ops/dispatch.py:139``
``apply``.

``apply(name, fn, *args, **attrs)`` unwraps ``Tensor`` arguments, casts
their floating values as AMP says for ``name`` (the same op names and
lists as paddle_tpu, so "linear" and "conv2d" cast alike), calls ``fn``
on torch tensors and wraps what it returns.  Torch autograd records the
graph as ``fn`` runs, so there is no tape here.  With the
``check_nan_inf`` flag set, every floating output is swept for NaN/Inf
and a hit raises ``FloatingPointError`` naming the op.  An error inside
``fn`` is re-raised as ``RuntimeError("[operator < name >] ...")``.

The JAX dispatcher's fallback for ops that run but cannot be linearized
is not ported: it exists for JAX's tracing, and torch autograd has no
such case."""
from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs
from ..framework.flags import flag_value

__all__ = ["apply"]


def _check_nan_inf(name, outs):
    for i, o in enumerate(outs):
        if isinstance(o, torch.Tensor) and o.is_floating_point():
            if not bool(torch.isfinite(o).all()):
                raise FloatingPointError(
                    f"Operator {name} output #{i} contains NaN or Inf "
                    "(FLAGS_check_nan_inf is set)")


def apply(name, fn, *args, **kwargs):
    """Run ``fn(*values, **kwargs)`` eagerly; returns a Tensor, or a
    tuple/list of Tensors mirroring ``fn``'s flat output."""
    from ..tensor import Tensor

    cast = iter(cast_inputs(name, *(a._value for a in args
                                     if isinstance(a, Tensor))))
    values = [next(cast) if isinstance(a, Tensor) else a for a in args]
    try:
        out = fn(*values, **kwargs)
    except Exception as e:
        raise RuntimeError(f"[operator < {name} >] {e}") from e
    single = not isinstance(out, (tuple, list))
    flat = (out,) if single else tuple(out)
    if flag_value("check_nan_inf"):
        _check_nan_inf(name, flat)
    wrapped = [Tensor(o) if isinstance(o, torch.Tensor) else o
               for o in flat]
    return wrapped[0] if single else type(out)(wrapped)
