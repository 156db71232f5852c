"""Math ops — twin of ``paddle_tpu/ops/math.py``: elementwise binary and
unary ops, reductions, scans and comparisons of closeness, each through
``dispatch.apply`` under the reference's op name.

Where the JAX function and torch's differ, the JAX semantics are kept:
``mod`` / ``remainder`` / ``floor_mod`` are floor-mod
(``torch.remainder``, not ``fmod``); ``median`` averages the two middle
values of an even count (``jnp.median``; ``torch.median`` returns the
lower); ``lerp`` is ``x + w * (y - x)``; ``axis=None`` flattens the
scans.  By design, integer results keep paddle's int64 where JAX
without 64-bit types gives int32 (``sum`` of an int32 tensor, the
indices of ``cummax``)."""
from __future__ import annotations

import builtins
import functools

import numpy as np
import torch

from ..framework import dtype as _dt
from ..tensor import Tensor
from ._helpers import binary_op, norm_axis, to_tensor_like, value_of
from .dispatch import apply

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "floor_mod", "pow", "maximum", "minimum", "fmax", "fmin",
    "atan2", "hypot", "logaddexp", "heaviside", "nextafter", "copysign",
    "gcd", "lcm", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "square", "abs", "sign", "neg", "reciprocal", "floor", "ceil",
    "round", "trunc", "frac", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "erf", "erfinv",
    "sigmoid", "digamma", "lgamma", "angle", "conj", "real", "imag",
    "deg2rad", "rad2deg", "scale", "increment", "clip", "lerp", "stanh",
    "multiplex", "sum", "mean", "max", "min", "prod", "logsumexp", "amax",
    "amin", "all", "any", "var", "std", "median", "quantile", "nanmean",
    "nansum", "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "add_n", "count_nonzero", "isfinite", "isinf", "isnan", "isclose",
    "allclose", "equal_all", "nan_to_num", "kron", "diff", "trace",
    "inner", "outer"]


def _unop(op_name, fn):
    def op(x, name=None):
        return apply(op_name, fn, to_tensor_like(x))

    op.__name__ = op_name
    return op


def _floating(v):
    """``v`` in the default float dtype unless it is floating already
    (JAX promotes an integer input of a transcendental op)."""
    return v if v.is_floating_point() or v.is_complex() else v.to(
        _dt.get_default_dtype())


def _float_unop(op_name, fn):
    return _unop(op_name, lambda v: fn(_floating(v)))


add = binary_op("add", torch.add)
subtract = binary_op("subtract", torch.sub)
multiply = binary_op("multiply", torch.mul)
divide = binary_op("divide", torch.true_divide)
floor_divide = binary_op("floor_divide", torch.floor_divide)
mod = binary_op("mod", torch.remainder)
remainder = mod
floor_mod = mod
pow = binary_op("pow", torch.pow)
maximum = binary_op("maximum", torch.maximum)
minimum = binary_op("minimum", torch.minimum)
fmax = binary_op("fmax", torch.fmax)
fmin = binary_op("fmin", torch.fmin)
atan2 = binary_op("atan2", lambda a, b: torch.atan2(_floating(a),
                                                 _floating(b)))
hypot = binary_op("hypot", torch.hypot)
logaddexp = binary_op("logaddexp", torch.logaddexp)
heaviside = binary_op("heaviside", torch.heaviside)
nextafter = binary_op("nextafter", torch.nextafter)
copysign = binary_op("copysign", torch.copysign)
gcd = binary_op("gcd", torch.gcd)
lcm = binary_op("lcm", torch.lcm)

exp = _float_unop("exp", torch.exp)
expm1 = _float_unop("expm1", torch.expm1)
log = _float_unop("log", torch.log)
log2 = _float_unop("log2", torch.log2)
log10 = _float_unop("log10", torch.log10)
log1p = _float_unop("log1p", torch.log1p)
sqrt = _float_unop("sqrt", torch.sqrt)
rsqrt = _float_unop("rsqrt", torch.rsqrt)
square = _unop("square", torch.square)
abs = _unop("abs", torch.abs)
sign = _unop("sign", torch.sign)
neg = _unop("neg", torch.neg)
reciprocal = _float_unop("reciprocal", torch.reciprocal)
floor = _unop("floor", torch.floor)
ceil = _unop("ceil", torch.ceil)
round = _unop("round", torch.round)
trunc = _unop("trunc", torch.trunc)
frac = _unop("frac", lambda v: v - torch.trunc(v))
sin = _float_unop("sin", torch.sin)
cos = _float_unop("cos", torch.cos)
tan = _float_unop("tan", torch.tan)
asin = _float_unop("asin", torch.asin)
acos = _float_unop("acos", torch.acos)
atan = _float_unop("atan", torch.atan)
sinh = _float_unop("sinh", torch.sinh)
cosh = _float_unop("cosh", torch.cosh)
tanh = _float_unop("tanh", torch.tanh)
asinh = _float_unop("asinh", torch.asinh)
acosh = _float_unop("acosh", torch.acosh)
atanh = _float_unop("atanh", torch.atanh)
erf = _float_unop("erf", torch.erf)
erfinv = _float_unop("erfinv", torch.erfinv)
sigmoid = _float_unop("sigmoid", torch.sigmoid)
digamma = _float_unop("digamma", torch.digamma)
lgamma = _float_unop("lgamma", torch.lgamma)
angle = _float_unop("angle", torch.angle)
conj = _unop("conj", lambda v: v.conj_physical() if v.is_complex() else v)
real = _unop("real", torch.real)
imag = _unop("imag", lambda v: torch.imag(v) if v.is_complex()
             else torch.zeros_like(v))
deg2rad = _float_unop("deg2rad", torch.deg2rad)
rad2deg = _float_unop("rad2deg", torch.rad2deg)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = to_tensor_like(x)
    s, b = value_of(scale), value_of(bias)

    def f(v):
        return v * s + b if bias_after_scale else (v + b) * s

    out = apply("scale", f, x)
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


def increment(x, value=1.0, name=None):
    x = to_tensor_like(x)
    return x._replace_from(apply("increment", lambda v: v + value, x))


def clip(x, min=None, max=None, name=None):
    x = to_tensor_like(x)
    lo = value_of(min) if min is not None else None
    hi = value_of(max) if max is not None else None
    return apply("clip", lambda v: torch.clamp(v, lo, hi), x)


def lerp(x, y, weight, name=None):
    x = to_tensor_like(x)
    y = to_tensor_like(y, x)
    if isinstance(weight, Tensor):
        return apply("lerp", lambda a, b, w: a + w * (b - a), x, y, weight)
    return apply("lerp", lambda a, b: a + weight * (b - a), x, y)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply("stanh", lambda v: scale_b * torch.tanh(scale_a * v),
                 to_tensor_like(x))


def multiplex(inputs, index, name=None):
    ts = [to_tensor_like(t) for t in inputs]
    index = to_tensor_like(index, ts[0])

    def f(idx, *xs):
        stacked = torch.stack(xs, dim=0)
        rows = idx.reshape(-1).long()
        return stacked[rows, torch.arange(xs[0].shape[0],
                                          device=stacked.device)]

    return apply("multiplex", f, index, *ts)


# --- reductions -------------------------------------------------------
def _dims(v, ax):
    """A reduction's dims: every axis for None, else a tuple."""
    if ax is None:
        return tuple(range(v.dim()))
    return (ax,) if isinstance(ax, int) else tuple(ax)


def _over(v, ax, fn, keepdim):
    """``fn(flat, -1)`` over the axes ``ax`` of ``v`` moved last and
    merged (for the torch reductions that take one dim)."""
    dims = sorted(d % builtins.max(v.dim(), 1) for d in _dims(v, ax))
    if v.dim() == 0:
        return fn(v.reshape(1), -1).reshape(())
    rest = [d for d in range(v.dim()) if d not in dims]
    moved = v.permute(rest + dims).reshape(
        [v.shape[d] for d in rest] + [-1])
    out = fn(moved, -1)
    if keepdim:
        for d in dims:
            out = out.unsqueeze(d)
    return out


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    d = _dt.convert_dtype(dtype)

    def f(v):
        return torch.sum(v, dim=_dims(v, ax), keepdim=keepdim, dtype=d)

    return apply("reduce_sum", f, x)


def mean(x, axis=None, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    return apply("reduce_mean", lambda v: torch.mean(
        _floating(v), dim=_dims(v, ax), keepdim=keepdim), x)


def max(x, axis=None, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    return apply("reduce_max", lambda v: torch.amax(
        v, dim=_dims(v, ax), keepdim=keepdim), x)


def min(x, axis=None, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    return apply("reduce_min", lambda v: torch.amin(
        v, dim=_dims(v, ax), keepdim=keepdim), x)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    d = _dt.convert_dtype(dtype)
    return apply("reduce_prod", lambda v: _over(
        v, ax, lambda t, dim: torch.prod(t, dim=dim, dtype=d), keepdim), x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    return apply("logsumexp", lambda v: torch.logsumexp(
        _floating(v), dim=_dims(v, ax), keepdim=keepdim), x)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def all(x, axis=None, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    return apply("reduce_all", lambda v: torch.amin(
        v.bool(), dim=_dims(v, ax), keepdim=keepdim), x)


def any(x, axis=None, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    return apply("reduce_any", lambda v: torch.amax(
        v.bool(), dim=_dims(v, ax), keepdim=keepdim), x)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    ddof = 1 if unbiased else 0
    return apply("var", lambda v: torch.var(
        _floating(v), dim=_dims(v, ax), correction=ddof, keepdim=keepdim),
        x)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    ddof = 1 if unbiased else 0
    return apply("std", lambda v: torch.std(
        _floating(v), dim=_dims(v, ax), correction=ddof, keepdim=keepdim),
        x)


def median(x, axis=None, keepdim=False, name=None):
    """The middle value, or the mean of the two middle values of an even
    count (``jnp.median``); NaN where a NaN is present."""
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    return apply("median", lambda v: _over(
        _floating(v), ax, lambda t, dim: torch.quantile(t, 0.5, dim=dim),
        keepdim), x)


def quantile(x, q, axis=None, keepdim=False, name=None):
    """Linear interpolation between the order statistics, as
    ``jnp.quantile``; a list of ``q`` adds a leading axis."""
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    qv = value_of(q)

    def f(v):
        v = _floating(v)
        if isinstance(qv, torch.Tensor):
            def q_of(t, dim):
                return torch.quantile(t, qv.to(t), dim=dim)
        elif np.ndim(qv):
            # one scalar q at a time: a q tensor would be copied to the
            # card (a host sync) and range-checked there (another)
            def q_of(t, dim):
                return torch.stack([torch.quantile(t, float(q), dim=dim)
                                    for q in np.ravel(qv)])
        else:
            def q_of(t, dim):
                return torch.quantile(t, float(qv), dim=dim)
        out = _over(v, ax, q_of, False)
        if keepdim:
            lead = 1 if np.ndim(qv) else 0
            for d in sorted(d % v.dim() for d in _dims(v, ax)):
                out = out.unsqueeze(d + lead)
        return out

    return apply("quantile", f, x)


def nanmean(x, axis=None, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    return apply("nanmean", lambda v: torch.nanmean(
        _floating(v), dim=_dims(v, ax), keepdim=keepdim), x)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    d = _dt.convert_dtype(dtype)
    return apply("nansum", lambda v: torch.nansum(
        v, dim=_dims(v, ax), keepdim=keepdim, dtype=d), x)


def cumsum(x, axis=None, dtype=None, name=None):
    x = to_tensor_like(x)
    d = _dt.convert_dtype(dtype)

    def f(v):
        if axis is None:
            return torch.cumsum(v.reshape(-1), 0, dtype=d)
        return torch.cumsum(v, axis, dtype=d)

    return apply("cumsum", f, x)


def cumprod(x, dim=None, dtype=None, name=None):
    x = to_tensor_like(x)
    d = _dt.convert_dtype(dtype)

    def f(v):
        if dim is None:
            return torch.cumprod(v.reshape(-1), 0, dtype=d)
        return torch.cumprod(v, dim, dtype=d)

    return apply("cumprod", f, x)


def _cum_extreme(op_name, better):
    """The running max (min) and, on ties, the LAST index reaching it
    (the reference's scan of ``where(v == running, arange, -1)``)."""
    def op(x, axis=None, dtype="int64", name=None):
        x = to_tensor_like(x)
        d = _dt.convert_dtype(dtype)

        def g(v):
            ax = 0 if axis is None else axis
            vv = v.reshape(-1) if axis is None else v
            vals = (torch.cummax if better == "max" else torch.cummin)(
                vv, ax).values
            n = vv.shape[ax]
            shape = [1] * vv.dim()
            shape[ax % vv.dim()] = n
            ar = torch.arange(n, device=vv.device).reshape(shape)
            idx = torch.where(vv == vals, ar, -1)
            return vals, torch.cummax(idx, ax).values.to(d)

        return apply(op_name, g, x)

    op.__name__ = op_name
    return op


cummax = _cum_extreme("cummax", "max")
cummin = _cum_extreme("cummin", "min")


def logcumsumexp(x, axis=None, name=None):
    x = to_tensor_like(x)

    def f(v):
        v = _floating(v)
        if axis is None:
            return torch.logcumsumexp(v.reshape(-1), 0)
        return torch.logcumsumexp(v, axis)

    return apply("logcumsumexp", f, x)


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        inputs = [inputs]
    ts = [to_tensor_like(t) for t in inputs]
    return apply("add_n", lambda *xs: functools.reduce(torch.add, xs), *ts)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    return apply("count_nonzero", lambda v: torch.sum(
        v != 0, dim=_dims(v, ax), keepdim=keepdim), x)


def isfinite(x, name=None):
    return apply("isfinite", torch.isfinite, to_tensor_like(x))


def isinf(x, name=None):
    return apply("isinf", torch.isinf, to_tensor_like(x))


def isnan(x, name=None):
    return apply("isnan", torch.isnan, to_tensor_like(x))


def _close(a, b, rtol, atol, equal_nan):
    dt = torch.promote_types(a.dtype, b.dtype)
    if not (dt.is_floating_point or dt.is_complex):
        dt = _dt.get_default_dtype()
    return torch.isclose(a.to(dt), b.to(dt), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = to_tensor_like(x)
    return apply("isclose", lambda a, b: _close(a, b, rtol, atol, equal_nan),
                 x, to_tensor_like(y, x))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool tensor (on the device: nothing is read back)."""
    x = to_tensor_like(x)
    return apply("allclose", lambda a, b: _close(
        a, b, rtol, atol, equal_nan).all(), x, to_tensor_like(y, x))


def equal_all(x, y, name=None):
    """A 0-d bool tensor: same shape and every element equal."""
    x = to_tensor_like(x)

    def f(a, b):
        if a.shape != b.shape:
            return torch.zeros((), dtype=torch.bool, device=a.device)
        return torch.all(a == b)

    return apply("equal_all", f, x, to_tensor_like(y, x))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply("nan_to_num", lambda v: torch.nan_to_num(
        v, nan=nan, posinf=posinf, neginf=neginf), to_tensor_like(x))


def kron(x, y, name=None):
    x = to_tensor_like(x)
    return apply("kron", torch.kron, x, to_tensor_like(y, x))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = to_tensor_like(x)
    pre = to_tensor_like(prepend, x) if prepend is not None else None
    app = to_tensor_like(append, x) if append is not None else None

    def f(v, p, a):
        def edge(e):
            if e is None:
                return None
            e = e.to(v.dtype)
            if e.dim() == 0:
                shape = list(v.shape)
                shape[axis] = 1
                e = e.expand(shape)
            return e

        return torch.diff(v, n=n, dim=axis, prepend=edge(p), append=edge(a))

    return apply("diff", f, x, pre, app)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply("trace", lambda v: torch.diagonal(
        v, offset, axis1, axis2).sum(-1), to_tensor_like(x))


def inner(x, y, name=None):
    x = to_tensor_like(x)
    return apply("inner", torch.inner, x, to_tensor_like(y, x))


def outer(x, y, name=None):
    x = to_tensor_like(x)
    return apply("outer", lambda a, b: torch.outer(
        a.reshape(-1), b.reshape(-1)), x, to_tensor_like(y, x))
