"""Search and sort ops — twin of ``paddle_tpu/ops/search.py``.

The reference's orders are kept: ``argsort(descending=True)`` is a
stable sort of ``-x`` (ties keep their order), ``topk`` and
``kthvalue`` break ties to the lower index (``jax.lax.top_k``, a stable
sort here; ``torch.topk`` leaves tie order open), ``sort(descending)``
flips the ascending sort.  ``mode`` (numpy on the host in the
reference) runs on the device: the smallest of the most frequent values
and the LAST index holding it.  ``nonzero`` and ``masked_select`` have
shapes that depend on the data, so they read back a count.  Indices are
int64 (the reference's are int32 without JAX's 64-bit types)."""
from __future__ import annotations

import torch

from ..framework import dtype as _dt
from ..tensor import Tensor
from ._helpers import operand, to_tensor_like, value_of
from .dispatch import apply

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue",
           "mode", "nonzero", "masked_select", "masked_fill",
           "searchsorted", "bucketize", "index_put"]


def _arg_extreme(op_name, fn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        x = to_tensor_like(x)
        d = _dt.convert_dtype(dtype)

        def f(v):
            if axis is None:
                return fn(v.reshape(-1), 0).to(d)
            return fn(v, axis, keepdim=keepdim).to(d)

        return apply(op_name, f, x)

    op.__name__ = op_name
    return op


argmax = _arg_extreme("argmax", torch.argmax)
argmin = _arg_extreme("argmin", torch.argmin)


def _stable_sort(v, dim, descending):
    """Values and indices of a stable sort; descending as the stable
    ascending sort of ``-v`` (bool and unsigned: torch's stable
    descending sort, the same order)."""
    if descending and v.dtype not in (torch.bool, torch.uint8):
        s, i = torch.sort(-v, dim=dim, stable=True)
        return -s, i
    return torch.sort(v, dim=dim, descending=descending, stable=True)


def argsort(x, axis=-1, descending=False, name=None):
    return apply("argsort", lambda v: _stable_sort(v, axis, descending)[1],
                 to_tensor_like(x))


def sort(x, axis=-1, descending=False, name=None):
    def f(v):
        s = torch.sort(v, dim=axis, stable=True).values
        return torch.flip(s, [axis]) if descending else s

    return apply("sort", f, to_tensor_like(x))


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """The ``k`` largest (smallest) values along ``axis`` (the last by
    default) and their int64 indices, ties to the lower index."""
    x = to_tensor_like(x)
    kk = int(value_of(k)) if not isinstance(k, Tensor) else int(k.item())
    ax = -1 if axis is None else axis

    def f(v):
        s, i = _stable_sort(v, ax, largest)
        return s.narrow(ax, 0, kk), i.narrow(ax, 0, kk)

    return apply("topk", f, x)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The ``k``-th smallest value along ``axis`` and its index in a
    stable ascending sort."""
    def f(v):
        s, i = torch.sort(v, dim=axis, stable=True)
        vals = s.select(axis, k - 1)
        idx = i.select(axis, k - 1)
        if keepdim:
            vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
        return vals, idx

    return apply("kthvalue", f, to_tensor_like(x))


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest among equally
    frequent ones, as ``np.unique``'s order gives) and the last index
    where it occurs."""
    def f(v):
        vv = torch.movedim(v, axis, -1)
        n = vv.shape[-1]
        flat = vv.reshape(-1, n).contiguous()
        s = torch.sort(flat, dim=-1).values
        count = (torch.searchsorted(s, s, right=True)
                 - torch.searchsorted(s, s, right=False))
        best = torch.gather(s, 1, torch.argmax(count, dim=-1,
                                               keepdim=True))
        ar = torch.arange(n, device=v.device).expand_as(flat)
        idx = torch.where(flat == best, ar, -1).amax(dim=-1)
        vals = best[:, 0].reshape(vv.shape[:-1])
        idx = idx.reshape(vv.shape[:-1])
        if keepdim:
            vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
        return vals, idx

    return apply("mode", f, to_tensor_like(x))


def nonzero(x, as_tuple=False):
    """int64 indices of the nonzero entries: ``[N, ndim]``, or a tuple of
    ``[N, 1]`` columns."""
    def f(v):
        idx = torch.nonzero(v)
        if as_tuple:
            return tuple(idx[:, d:d + 1] for d in range(v.dim()))
        return idx

    return apply("nonzero", f, to_tensor_like(x))


def masked_select(x, mask, name=None):
    x = to_tensor_like(x)
    return apply("masked_select", lambda a, m: torch.masked_select(
        a, m.bool()), x, to_tensor_like(mask, x))


def masked_fill(x, mask, value, name=None):
    x = to_tensor_like(x)
    mask = to_tensor_like(mask, x)

    def f(a, m, val):
        if isinstance(val, torch.Tensor):
            val = val.to(a.dtype)
        else:
            val = torch.full((), val, dtype=a.dtype, device=a.device)
        return torch.where(m.bool(), val, a)

    return apply("masked_fill", f, x, mask, operand(value, x))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    ss = to_tensor_like(sorted_sequence)
    return apply("searchsorted", lambda a, b: torch.searchsorted(
        a.contiguous(), b.contiguous(), out_int32=out_int32, right=right),
        ss, to_tensor_like(values, ss))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_put(x, indices, value, accumulate=False, name=None):
    x = to_tensor_like(x)
    idx = tuple(to_tensor_like(i, x)._value for i in indices)
    return apply("index_put", lambda v, val: v.index_put(
        idx, val.to(v.dtype), accumulate=accumulate), x,
        to_tensor_like(value, x))
