"""Shape ops of the dygraph core — twins of ``paddle_tpu/ops/
manipulation.py``'s ``reshape``, ``flatten``, ``transpose``, ``concat``,
``stack``, ``split``, ``squeeze``, ``unsqueeze`` and ``expand``,
dispatched under the same op names."""
from __future__ import annotations

import torch

from ._helpers import norm_axis, norm_shape, to_tensor_like, value_of
from .dispatch import apply

__all__ = ["reshape", "flatten", "transpose", "concat", "stack", "split",
           "squeeze", "unsqueeze", "expand"]


def reshape(x, shape, name=None):
    shp = tuple(int(s) for s in shape)
    return apply("reshape", lambda v: v.reshape(shp), to_tensor_like(x))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Merge axes ``start_axis..stop_axis`` (inclusive) into one."""
    x = to_tensor_like(x)
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0

    def f(v):
        shp = list(v.shape)
        flat = 1
        for d in shp[s:e + 1]:
            flat *= d
        return v.reshape(shp[:s] + [flat] + shp[e + 1:])

    return apply("flatten", f, x)


def transpose(x, perm=None, name=None):
    """Permute the axes (reversed when ``perm`` is None, as numpy)."""
    x = to_tensor_like(x)
    p = (tuple(range(x.ndim))[::-1] if perm is None
         else tuple(int(a) for a in perm))
    return apply("transpose", lambda v: v.permute(p), x)


def concat(x, axis=0, name=None):
    ts = [to_tensor_like(t) for t in x]
    ax = int(value_of(axis))
    return apply("concat", lambda *vs: torch.cat(vs, dim=ax), *ts)


def stack(x, axis=0, name=None):
    ts = [to_tensor_like(t) for t in x]
    return apply("stack", lambda *vs: torch.stack(vs, dim=axis), *ts)


def split(x, num_or_sections, axis=0, name=None):
    """A list of pieces along ``axis``: ``num_or_sections`` equal ones
    (which must divide the axis), or pieces of the listed sizes, one of
    which may be -1 (the rest)."""
    x = to_tensor_like(x)
    ax = int(value_of(axis))
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"paddle.split: axis {ax} length {dim} is not divisible by "
                f"num_or_sections={num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(value_of(s)) for s in num_or_sections]
        neg = [i for i, s in enumerate(sizes) if s < 0]
        if neg:
            sizes[neg[0]] = dim - sum(s for s in sizes if s >= 0)
    out = apply("split", lambda v: tuple(torch.split(v, sizes, dim=ax)), x)
    return list(out)


def squeeze(x, axis=None, name=None):
    """Drop size-1 axes: all of them, or those of ``axis`` that are 1."""
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    if isinstance(ax, int):
        ax = (ax,)

    def f(v):
        if ax is None:
            return v.squeeze()
        real = tuple(a for a in ax if v.shape[a] == 1)
        return v.squeeze(real) if real else v

    return apply("squeeze", f, x)


def unsqueeze(x, axis, name=None):
    """Insert size-1 axes at the positions of ``axis`` (of the result)."""
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    if isinstance(ax, int):
        ax = (ax,)

    def f(v):
        nd = v.dim() + len(ax)
        for a in sorted(a % nd for a in ax):
            v = v.unsqueeze(a)
        return v

    return apply("unsqueeze", f, x)


def expand(x, shape, name=None):
    """Broadcast to ``shape``; -1 keeps that axis."""
    x = to_tensor_like(x)
    shp = list(norm_shape(shape))
    xs = x.shape
    off = len(shp) - len(xs)
    for i, s in enumerate(shp):
        if s == -1:
            shp[i] = xs[i - off]
    return apply("expand", lambda v: v.expand(tuple(shp)), x)
