"""Shape, layout, gather and scatter ops — twin of ``paddle_tpu/ops/
manipulation.py``, dispatched under the same op names.

The in-place forms (``reshape_``, ``squeeze_``, ``unsqueeze_``) adopt
the out-of-place result (``Tensor._replace_from``); ``transpose_`` is
``transpose``, as in the reference.  ``unique`` and
``unique_consecutive`` (numpy on the host in the reference) run on the
device with ``np.unique``'s order and its ``return_index`` (first
occurrence), ``return_inverse`` and ``return_counts``; their shapes
depend on the data, so they read back a count.  ``take`` in "raise"
mode checks the indices on the host, as the reference does, and wraps
a negative index (``-size <= i < size``); the reference clips it to 0
(ROADMAP §3).  Index results are int64."""
from __future__ import annotations

import builtins

import torch
import torch.nn.functional as torch_F

from ._helpers import norm_axis, norm_shape, to_tensor_like, value_of
from .dispatch import apply

__all__ = ["reshape", "reshape_", "transpose", "transpose_", "t",
           "moveaxis", "swapaxes", "concat", "stack", "unstack", "split",
           "chunk", "squeeze", "squeeze_", "unsqueeze", "unsqueeze_",
           "flatten", "gather", "gather_nd", "take_along_axis",
           "put_along_axis", "scatter", "scatter_nd_add", "scatter_nd",
           "index_select", "index_sample", "take", "expand", "expand_as",
           "broadcast_to", "broadcast_tensors", "broadcast_shape", "tile",
           "roll", "flip", "rot90", "slice", "strided_slice", "pad",
           "repeat_interleave", "unbind", "unique", "unique_consecutive",
           "as_complex", "as_real", "crop", "shard_index", "tensordot"]

_slice = builtins.slice


def reshape(x, shape, name=None):
    x = to_tensor_like(x)
    shp = norm_shape(shape)
    return apply("reshape", lambda v: v.reshape(shp), x)


def reshape_(x, shape, name=None):
    x = to_tensor_like(x)
    return x._replace_from(reshape(x, shape))


def transpose(x, perm=None, name=None):
    """Permute the axes (reversed when ``perm`` is None, as numpy)."""
    x = to_tensor_like(x)
    p = (tuple(range(x.ndim))[::-1] if perm is None
         else tuple(int(a) for a in perm))
    return apply("transpose", lambda v: v.permute(p), x)


transpose_ = transpose


def t(x, name=None):
    x = to_tensor_like(x)
    if x.ndim > 2:
        raise ValueError("paddle.t only supports ndim <= 2")
    return apply("t", lambda v: v.t(), x)


def moveaxis(x, source, destination, name=None):
    return apply("moveaxis", lambda v: torch.movedim(v, source, destination),
                 to_tensor_like(x))


def swapaxes(x, axis1, axis2, name=None):
    return apply("swapaxes", lambda v: torch.swapaxes(v, axis1, axis2),
                 to_tensor_like(x))


def concat(x, axis=0, name=None):
    ts = [to_tensor_like(t) for t in x]
    ax = int(value_of(axis))
    return apply("concat", lambda *vs: torch.cat(vs, dim=ax), *ts)


def stack(x, axis=0, name=None):
    ts = [to_tensor_like(t) for t in x]
    return apply("stack", lambda *vs: torch.stack(vs, dim=axis), *ts)


def unstack(x, axis=0, num=None, name=None):
    x = to_tensor_like(x)
    return list(apply("unstack", lambda v: tuple(torch.unbind(v, axis)), x))


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
            sizes[neg[0]] = dim - builtins.sum(s for s in sizes if s >= 0)
    out = apply("split", lambda v: tuple(torch.split(v, sizes, dim=ax)), x)
    return list(out)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


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


def squeeze_(x, axis=None, name=None):
    x = to_tensor_like(x)
    return x._replace_from(squeeze(x, axis))


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


def unsqueeze_(x, axis, name=None):
    x = to_tensor_like(x)
    return x._replace_from(unsqueeze(x, axis))


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


def _index_tuple(idx):
    """The columns of ``idx[..., k]`` as an advanced index."""
    idx = idx.long()
    return tuple(idx[..., i] for i in range(idx.shape[-1]))


def gather(x, index, axis=0, name=None):
    x = to_tensor_like(x)
    ax = int(value_of(axis))
    return apply("gather", lambda v, i: torch.index_select(
        v, ax, i.reshape(-1).long()), x, to_tensor_like(index, x))


def gather_nd(x, index, name=None):
    x = to_tensor_like(x)
    return apply("gather_nd", lambda v, idx: v[_index_tuple(idx)], x,
                 to_tensor_like(index, x))


def take_along_axis(arr, indices, axis, name=None):
    arr = to_tensor_like(arr)
    return apply("take_along_axis", lambda v, i: torch.take_along_dim(
        v, i.long(), dim=axis), arr, to_tensor_like(indices, arr))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """``arr`` with ``values`` (broadcast to the indices' shape) written,
    added (``"add"``) or multiplied (``"multiply"``/``"mul"``) at
    ``indices`` along ``axis``."""
    arr = to_tensor_like(arr)

    def f(v, i, val):
        i = i.long()
        val = torch.broadcast_to(val.to(v.dtype), i.shape)
        if reduce == "add":
            return v.scatter_add(axis, i, val)
        if reduce in ("multiply", "mul"):
            return v.scatter_reduce(axis, i, val, "prod", include_self=True)
        return v.scatter(axis, i, val)

    return apply("put_along_axis", f, arr, to_tensor_like(indices, arr),
                 to_tensor_like(values, arr))


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of x replaced by ``updates`` (``overwrite``), or
    zeroed and then summed over their updates."""
    x = to_tensor_like(x)

    def f(v, i, u):
        i = i.reshape(-1).long()
        u = u.to(v.dtype)
        if overwrite:
            return v.index_copy(0, i, u)
        return v.index_fill(0, i, 0).index_add(0, i, u)

    return apply("scatter", f, x, to_tensor_like(index, x),
                 to_tensor_like(updates, x))


def scatter_nd_add(x, index, updates, name=None):
    x = to_tensor_like(x)
    return apply("scatter_nd_add", lambda v, idx, u: v.index_put(
        _index_tuple(idx), u.to(v.dtype), accumulate=True), x,
        to_tensor_like(index, x), to_tensor_like(updates, x))


def scatter_nd(index, updates, shape, name=None):
    index = to_tensor_like(index)
    shp = norm_shape(shape)

    def f(idx, u):
        z = torch.zeros(shp, dtype=u.dtype, device=u.device)
        return z.index_put(_index_tuple(idx), u, accumulate=True)

    return apply("scatter_nd", f, index, to_tensor_like(updates, index))


def index_select(x, index, axis=0, name=None):
    x = to_tensor_like(x)
    return apply("index_select", lambda v, i: torch.index_select(
        v, axis, i.reshape(-1).long()), x, to_tensor_like(index, x))


def index_sample(x, index):
    x = to_tensor_like(x)
    return apply("index_sample", lambda v, i: torch.take_along_dim(
        v, i.long(), dim=1), x, to_tensor_like(index, x))


def take(x, index, mode="raise", name=None):
    """Elements of the flattened x at ``index``: "raise" checks
    ``-size <= i < size`` on the host and wraps a negative index,
    "wrap" takes indices modulo the size, "clip" clamps them into
    ``[0, size)``."""
    x = to_tensor_like(x)
    index = to_tensor_like(index, x)
    n = x.size
    if mode == "raise":
        iv = index.numpy()
        if iv.size and (iv.min() < -n or iv.max() >= n):
            raise IndexError(
                f"paddle.take: index out of range for tensor of size {n}")

    def f(v, i):
        i = i.long()
        if mode == "clip":
            i = torch.clamp(i, 0, n - 1)
        else:
            i = torch.remainder(i, n)
        return v.reshape(-1)[i]

    return apply("take", f, x, index)


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


def expand_as(x, y, name=None):
    x = to_tensor_like(x)
    return apply("expand_as", lambda v, w: v.expand(w.shape), x,
                 to_tensor_like(y, x))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    ts = [to_tensor_like(t) for t in inputs]
    return list(apply("broadcast_tensors", lambda *vs: tuple(
        torch.broadcast_tensors(*vs)), *ts))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def tile(x, repeat_times, name=None):
    reps = norm_shape(repeat_times)
    return apply("tile", lambda v: torch.tile(v, reps), to_tensor_like(x))


def roll(x, shifts, axis=None, name=None):
    def f(v):
        if axis is None:
            return torch.roll(v.reshape(-1), shifts).reshape(v.shape)
        return torch.roll(v, shifts, dims=axis)

    return apply("roll", f, to_tensor_like(x))


def flip(x, axis, name=None):
    ax = norm_axis(axis)
    dims = [ax] if isinstance(ax, int) else list(ax)
    return apply("flip", lambda v: torch.flip(v, dims), to_tensor_like(x))


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply("rot90", lambda v: torch.rot90(v, k, list(axes)),
                 to_tensor_like(x))


def slice(input, axes, starts, ends):
    """``input[starts:ends]`` on each of ``axes`` (bounds clamped into the
    axis, negative ones counted from its end)."""
    input = to_tensor_like(input)
    axes = [int(a) for a in axes]
    starts = [int(value_of(s)) for s in starts]
    ends = [int(value_of(e)) for e in ends]

    def f(v):
        idx = [_slice(None)] * v.dim()
        for a, s, e in zip(axes, starts, ends):
            dim = v.shape[a]
            s2 = builtins.max(s + dim, 0) if s < 0 else builtins.min(s, dim)
            e2 = builtins.max(e + dim, 0) if e < 0 else builtins.min(e, dim)
            idx[a] = _slice(s2, e2)
        return v[tuple(idx)]

    return apply("slice", f, input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slices ``start:end:stride`` on ``axes`` (a negative stride
    walks backwards, as numpy's)."""
    x = to_tensor_like(x)
    spec = [(int(a), int(value_of(s)), int(value_of(e)), int(value_of(st)))
            for a, s, e, st in zip(axes, starts, ends, strides)]

    def f(v):
        for a, s, e, st in spec:
            idx = [_slice(None)] * v.dim()
            if st > 0:
                idx[a] = _slice(s, e, st)
            else:
                # the same positions, read forwards from the flipped axis
                dim = v.shape[a]
                keep = range(dim)[_slice(s, e, st)]
                v = v.flip(a)
                idx[a] = (_slice(0, 0) if not keep else _slice(
                    dim - 1 - keep[0], dim - keep[-1], -st))
            v = v[tuple(idx)]
        return v

    return apply("strided_slice", f, x)


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate", "circular": "circular"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's pad: a full-rank constant pad ``[d0_lo, d0_hi, d1_lo,
    ...]`` (op "pad"), or the spatial axes of an N, C, spatial tensor
    padded last axis first, ``[left, right, top, bottom, ...]``, in one
    of the modes "constant", "reflect", "replicate" and "circular"
    (op "pad3d")."""
    x = to_tensor_like(x)
    pads = [int(value_of(p)) for p in (pad.tolist() if hasattr(
        pad, "tolist") else pad)]
    if len(pads) == 2 * x.ndim and mode == "constant":
        flat = []
        for i in reversed(range(x.ndim)):
            flat += [pads[2 * i], pads[2 * i + 1]]
        return apply("pad", lambda v: torch_F.pad(v, flat, value=value), x)
    channel_last = not data_format.startswith("NC")
    # the leading spatial axes unnamed by ``pad`` are not padded
    pads = pads + [0] * builtins.max(0, 2 * (x.ndim - 2) - len(pads))

    def f(v):
        if channel_last:
            v = torch.movedim(v, -1, 1)
        if mode == "constant":
            out = torch_F.pad(v, pads, value=value)
        else:
            out = torch_F.pad(v, pads, mode=_PAD_MODES[mode])
        return torch.movedim(out, 1, -1) if channel_last else out

    return apply("pad3d", f, x)


def repeat_interleave(x, repeats, axis=None, name=None):
    x = to_tensor_like(x)
    r = value_of(repeats)
    return apply("repeat_interleave", lambda v: torch.repeat_interleave(
        v, r, dim=axis), x)


def unbind(input, axis=0):
    return unstack(input, axis=axis)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted unique values (of the flattened x, or its slices along
    ``axis``), then as asked: the index of each one's first occurrence,
    the inverse map and the counts (in ``dtype``)."""
    from ..framework.dtype import convert_dtype

    d = convert_dtype(dtype)
    x = to_tensor_like(x)

    def f(v):
        vv = v.reshape(-1) if axis is None else v
        uniq, inv, counts = torch.unique(vv, sorted=True, return_inverse=True,
                                         return_counts=True, dim=axis)
        outs = [uniq]
        if return_index:
            n = vv.shape[0 if axis is None else axis]
            first = torch.full((uniq.shape[0 if axis is None else axis],), n,
                               dtype=torch.long, device=v.device)
            first = first.scatter_reduce(0, inv, torch.arange(
                n, device=v.device), "amin")
            outs.append(first.to(d))
        if return_inverse:
            outs.append(inv.to(d))
        if return_counts:
            outs.append(counts.to(d))
        return outs[0] if len(outs) == 1 else tuple(outs)

    return apply("unique", f, x)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """The values (rows along ``axis``) with each run of equal
    neighbours collapsed to one (the flattened x when ``axis`` is
    None), then the inverse map and the run lengths as asked."""
    from ..framework.dtype import convert_dtype

    d = convert_dtype(dtype)

    def f(v):
        vv = v.reshape(-1) if axis is None else v
        vals, inv, counts = torch.unique_consecutive(
            vv, return_inverse=True, return_counts=True, dim=axis)
        outs = [vals]
        if return_inverse:
            outs.append(inv.to(d))
        if return_counts:
            outs.append(counts.to(d))
        return outs[0] if len(outs) == 1 else tuple(outs)

    return apply("unique_consecutive", f, to_tensor_like(x))


def as_complex(x, name=None):
    return apply("as_complex", lambda v: torch.complex(v[..., 0], v[..., 1]),
                 to_tensor_like(x))


def as_real(x, name=None):
    return apply("as_real", lambda v: torch.stack(
        [torch.real(v), torch.imag(v)], dim=-1), to_tensor_like(x))


def crop(x, shape=None, offsets=None, name=None):
    x = to_tensor_like(x)
    shp = norm_shape(shape)
    offs = ([0] * x.ndim if offsets is None
            else [int(value_of(o)) for o in offsets])
    idx = tuple(_slice(o, o + s) for o, s in zip(offs, shp))
    return apply("crop", lambda v: v[idx], x)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Each index as its offset within shard ``shard_id`` of
    ``index_num`` indices cut into ``nshards``, else ``ignore_value``."""
    size = (index_num + nshards - 1) // nshards

    def f(v):
        return torch.where(v // size == shard_id, v % size,
                           torch.full_like(v, ignore_value))

    return apply("shard_index", f, to_tensor_like(input))


def tensordot(x, y, axes=2, name=None):
    x = to_tensor_like(x)
    if isinstance(axes, (list, tuple)):
        axes = [[int(i) for i in a] if isinstance(a, (list, tuple))
                else int(a) for a in axes]
    return apply("tensordot", lambda a, b: torch.tensordot(a, b, dims=axes),
                 x, to_tensor_like(y, x))
