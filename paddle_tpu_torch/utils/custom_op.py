"""User custom ops — twin of ``paddle_tpu/utils/custom_op.py``
(``register_op``, ``get_op``, ``unregister_op``, ``registered_ops``).

A registered op is a torch function on tensors — plain torch code or a
launch of a hand-written kernel.  Calling it goes through
``ops.dispatch.apply`` under the op's name, so AMP casts it by the op
lists, the NaN/Inf sweep checks it and an error carries the operator
prefix.  Its gradient is one of:

- ``vjp=`` (recompute style): ``vjp(ct, *inputs, **attrs) -> grads``,
  one per input;
- ``fwd=``/``bwd=``: ``fwd(*inputs, **attrs) -> (out, residuals)`` and
  ``bwd(residuals, ct, **attrs) -> grads``;
- neither: torch autograd differentiates ``fn`` itself.

With a custom gradient the op becomes a ``torch.autograd.Function``,
built once per set of attrs (the twin of ``CustomOp._jfn``).

Example::

    import torch
    from paddle_tpu_torch.utils import register_op

    op = register_op("my_swish",
                     lambda x, beta=1.0: x * torch.sigmoid(beta * x))
    y = op(x, beta=2.0)          # x a paddle_tpu_torch Tensor
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

__all__ = ["CustomOp", "register_op", "get_op", "registered_ops",
           "unregister_op"]

_REGISTRY: Dict[str, "CustomOp"] = {}


def _as_tuple(g):
    return tuple(g) if isinstance(g, (list, tuple)) else (g,)


def _save(ctx, res):
    """Keep ``res`` (a value, or a tuple/list of values) for backward:
    its tensors through ``save_for_backward`` (no reference cycle
    through ``ctx`` when one is the output), everything else on
    ``ctx``."""
    seq = isinstance(res, (tuple, list))
    flat = tuple(res) if seq else (res,)
    is_t = [isinstance(r, torch.Tensor) for r in flat]
    ctx.save_for_backward(*(r for r, t in zip(flat, is_t) if t))
    ctx.res_layout = (type(res) if seq else None, is_t,
                      [None if t else r for r, t in zip(flat, is_t)])


def _restore(ctx):
    typ, is_t, others = ctx.res_layout
    tensors = iter(ctx.saved_tensors)
    flat = [next(tensors) if t else o for t, o in zip(is_t, others)]
    return flat[0] if typ is None else typ(flat)


class CustomOp:
    """A registered user op (callable on Tensors and static attrs)."""

    def __init__(self, name: str, fn: Callable, vjp: Optional[Callable],
                 fwd: Optional[Callable], bwd: Optional[Callable]):
        self.name = name
        self._fn = fn
        self._vjp, self._fwd, self._bwd = vjp, fwd, bwd
        self._tfn_cache: Dict[tuple, Callable] = {}

    def _tfn(self, attrs: tuple) -> Callable:
        """The torch callable for one set of static attrs, with the
        user's gradient wired in when one was given."""
        if attrs in self._tfn_cache:
            return self._tfn_cache[attrs]
        kw = dict(attrs)
        fn, vjp, fwd, bwd = self._fn, self._vjp, self._fwd, self._bwd
        if vjp is None and bwd is None:
            def tfn(*values):
                return fn(*values, **kw)
        else:
            class _Op(torch.autograd.Function):
                @staticmethod
                def forward(ctx, *values):
                    if bwd is not None:
                        out, res = fwd(*values, **kw)
                        _save(ctx, res)
                    else:
                        out = fn(*values, **kw)
                        _save(ctx, values)
                    return out

                @staticmethod
                def backward(ctx, *cts):
                    ct = cts[0] if len(cts) == 1 else cts
                    res = _restore(ctx)
                    if bwd is not None:
                        return _as_tuple(bwd(res, ct, **kw))
                    return _as_tuple(vjp(ct, *res, **kw))

            _Op.__name__ = f"CustomOp_{self.name}"
            tfn = _Op.apply
        self._tfn_cache[attrs] = tfn
        return tfn

    def __call__(self, *tensors, **attrs):
        from ..ops.dispatch import apply

        key = tuple(sorted(attrs.items()))
        return apply(self.name, self._tfn(key), *tensors)


def register_op(name: str, fn: Callable, vjp: Optional[Callable] = None,
                fwd: Optional[Callable] = None,
                bwd: Optional[Callable] = None, amp: Optional[str] = None,
                exist_ok: bool = False) -> CustomOp:
    """Register a user op under ``name`` and return it as a callable
    taking Tensors (and static attrs as keywords).

    ``amp="white"`` adds ``name`` to the AMP white list (its floating
    inputs run in the low dtype under ``amp.auto_cast``), ``"black"`` to
    the black list (float32); either stays for the life of the process,
    as in paddle_tpu.  ``exist_ok`` allows replacing an op of the same
    name."""
    if (vjp is not None) and (bwd is not None):
        raise ValueError("pass either vjp= or fwd=/bwd=, not both")
    if (bwd is None) != (fwd is None):
        raise ValueError("fwd= and bwd= must be given together")
    if name in _REGISTRY and not exist_ok:
        raise ValueError(f"op {name!r} already registered "
                         "(pass exist_ok=True to replace)")
    if amp not in (None, "white", "black"):
        raise ValueError("amp must be None, 'white' or 'black'")
    if amp:
        from ..amp.auto_cast import black_list, white_list

        (white_list if amp == "white" else black_list).add(name)
    op = CustomOp(name, fn, vjp, fwd, bwd)
    _REGISTRY[name] = op
    return op


def get_op(name: str) -> CustomOp:
    return _REGISTRY[name]


def registered_ops():
    return sorted(_REGISTRY)


def unregister_op(name: str) -> None:
    _REGISTRY.pop(name, None)
