"""The collectives of a :func:`~.mesh.shard_map` body — the port's
twins of the ``jax.lax`` primitives the JAX package's distributed code
calls inside ``shard_map``: ``axis_index``, ``axis_size`` (``psum(1,
axis)``), ``psum``, ``pmax``, ``pmin``, ``pmean``, ``all_gather``,
``psum_scatter``, ``ppermute`` and ``all_to_all``.

Each is a meeting of every slot of the run (``mesh.exchange``): the last
slot to arrive computes the collective for every group of the axis with
plain tensor operations, and each slot gets its piece.  Autograd records
those operations, so a collective is differentiable and its backward is
the true adjoint of the joint map: the cotangent of a ``psum`` input is
the sum of its group's output cotangents, of an ``all_gather`` input
the sum of its slice's, of a ``ppermute`` the inverse permutation — the
transposes ``shard_map`` gives these primitives in the JAX package (with
``check_vma=False``).  A value leaves a collective on the device of the
slot that receives it; slots that share a device share one result
tensor, which the body must not modify in place.

:func:`joint` makes a custom collective, one ``torch.autograd.Function``
over every member of each group with its own forward and backward: the
hybrid step's ``_mp_copy`` (identity forward, psum backward) is one.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from . import mesh as _mesh

__all__ = ["axis_index", "axis_size", "psum", "pmax", "pmin", "pmean",
           "all_gather", "psum_scatter", "ppermute", "all_to_all", "joint"]


def axis_index(axis_name) -> int:
    """This slot's position along ``axis_name`` (an axis, or a tuple of
    axes in row-major order)."""
    ctx = _mesh.current_slot()
    pos = 0
    for a in _mesh._axes_tuple(axis_name):
        pos = pos * ctx.mesh.shape[a] + ctx.coords[a]
    return pos


def axis_size(axis_name) -> int:
    """The number of slots along ``axis_name`` (``psum(1, axis)``)."""
    return _mesh.current_slot().mesh.axis_size(axis_name)


def _grouped(op: str, axis_name, x, per_group: Callable[[list], list]):
    """Meet at a collective over ``axis_name``: ``per_group(values of one
    group in axis order)`` returns that group's results in the same
    order."""
    mesh = _mesh.current_slot().mesh

    def compute(vals):
        out = [None] * len(vals)
        for g in mesh.groups(axis_name):
            res = per_group([vals[i] for i in g])
            for i, r in zip(g, res):
                out[i] = r
        return out

    return _mesh.exchange(op, axis_name, x, compute)


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The sum over the group, on every member."""
    if not isinstance(x, torch.Tensor):
        return x * axis_size(axis_name)
    return _grouped("psum", axis_name, x, _mesh.psum)


def pmax(x: torch.Tensor, axis_name) -> torch.Tensor:
    return _grouped("pmax", axis_name, x, _mesh.pmax)


def pmin(x: torch.Tensor, axis_name) -> torch.Tensor:
    return _grouped("pmin", axis_name, x, _mesh.pmin)


def pmean(x: torch.Tensor, axis_name) -> torch.Tensor:
    return psum(x, axis_name) / axis_size(axis_name)


def all_gather(x: torch.Tensor, axis_name, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """The members' values stacked along a new dim ``axis`` (or, with
    ``tiled``, concatenated along ``axis``), on every member."""
    def gather(vals):
        if tiled:
            return _mesh.all_gather(vals, axis)
        d = axis if axis >= 0 else axis + vals[0].dim() + 1
        return _mesh.all_gather([v.unsqueeze(d) for v in vals], d)

    return _grouped("all_gather", axis_name, x, gather)


def psum_scatter(x: torch.Tensor, axis_name, scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """The group's sum, member p keeping block p of ``scatter_dimension``
    (a slice of ``size / n`` with ``tiled``; else index p, the dim of size
    n dropped)."""
    d = scatter_dimension

    def scatter(vals):
        n = len(vals)
        total = _mesh.psum(vals)[0]
        if total.shape[d] % n:
            raise ValueError(f"psum_scatter: dim {d} of size "
                             f"{total.shape[d]} does not split {n} ways")
        k = total.shape[d] // n
        if not tiled and k != 1:
            raise ValueError(f"psum_scatter(tiled=False) needs dim {d} of "
                             f"size {n}, got {total.shape[d]}")
        out = []
        for p, v in enumerate(vals):
            piece = total.narrow(d, p * k, k)
            out.append((piece if tiled else piece.squeeze(d)).to(v.device))
        return out

    return _grouped("psum_scatter", axis_name, x, scatter)


def ppermute(x: torch.Tensor, axis_name,
             perm: Sequence[tuple]) -> torch.Tensor:
    """Send member ``src``'s value to member ``dst`` for each ``(src,
    dst)`` of ``perm``; a member that receives nothing gets zeros."""
    pairs = [(int(s), int(t)) for s, t in perm]

    def permute(vals):
        out = [None] * len(vals)
        for s, t in pairs:
            # a copy even on one device: the receiver's value must not
            # alias the sender's, which the sender may overwrite in place
            out[t] = vals[s].to(vals[t].device, copy=True)
        return [o if o is not None else torch.zeros_like(v)
                for o, v in zip(out, vals)]

    return _grouped(("ppermute", tuple(pairs)), axis_name, x, permute)


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int, tiled: bool = False) -> torch.Tensor:
    """Member p gets block p of every member's ``split_axis``, in member
    order along ``concat_axis``: concatenated with ``tiled`` (each member
    split into n blocks), else stacked (``split_axis`` of size n)."""
    def exchange(vals):
        n = len(vals)
        if tiled:
            parts = [v.chunk(n, split_axis) if v.shape[split_axis] % n == 0
                     else _bad_split(v, split_axis, n) for v in vals]
            return [torch.cat([parts[j][p].to(vals[p].device)
                               for j in range(n)], dim=concat_axis)
                    for p in range(n)]
        for v in vals:
            if v.shape[split_axis] != n:
                raise ValueError(f"all_to_all(tiled=False) needs dim "
                                 f"{split_axis} of size {n}, got "
                                 f"{v.shape[split_axis]}")
        return [torch.stack([vals[j].select(split_axis, p).to(
            vals[p].device) for j in range(n)], dim=concat_axis)
            for p in range(n)]

    return _grouped("all_to_all", axis_name, x, exchange)


def _bad_split(v, axis, n):
    raise ValueError(f"all_to_all: dim {axis} of size {v.shape[axis]} does "
                     f"not split {n} ways")


class _Joint(torch.autograd.Function):
    """One node over every member of every group: ``forward(list) ->
    list`` and ``backward(list of output grads) -> list of input
    grads`` per group."""

    @staticmethod
    def forward(ctx, spec, *xs):
        groups, fwd, bwd = spec
        ctx.spec = spec
        out = [None] * len(xs)
        for g in groups:
            res = fwd([xs[i] for i in g])
            for i, r in zip(g, res):
                out[i] = r
        return tuple(o if o is not x else o.view_as(o)
                     for o, x in zip(out, xs))

    @staticmethod
    def backward(ctx, *gs):
        groups, fwd, bwd = ctx.spec
        out = [None] * len(gs)
        for g in groups:
            res = bwd([gs[i] for i in g])
            for i, r in zip(g, res):
                out[i] = r
        return (None, *out)


def joint(name: str, x: torch.Tensor, axis_name,
          forward: Callable[[List[torch.Tensor]], List[torch.Tensor]],
          backward: Callable[[List[torch.Tensor]], List[torch.Tensor]]
          ) -> torch.Tensor:
    """A custom collective over ``axis_name`` whose backward is
    ``backward`` (members' output grads in axis order -> their input
    grads), computed as one autograd node over every slot."""
    mesh = _mesh.current_slot().mesh
    groups = mesh.groups(axis_name)

    def compute(vals):
        return list(_Joint.apply((groups, forward, backward), *vals))

    return _mesh.exchange(("joint", name), axis_name, x, compute)
