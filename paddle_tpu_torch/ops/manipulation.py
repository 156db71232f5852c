"""Shape ops of the dygraph core — twins of ``paddle_tpu/ops/
manipulation.py``'s ``reshape`` and ``flatten``, dispatched under the same
op names."""
from __future__ import annotations

from .dispatch import apply

__all__ = ["reshape", "flatten"]


def reshape(x, shape, name=None):
    shp = tuple(int(s) for s in shape)
    return apply("reshape", lambda v: v.reshape(shp), x)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Merge axes ``start_axis..stop_axis`` (inclusive) into one."""
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
