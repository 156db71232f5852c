"""Pooling — twin of ``paddle_tpu/nn/functional/pooling.py``: max and
average pooling in 1, 2 and 3 dimensions, adaptive average and max
pooling, ``max_pool2d(return_mask=True)`` and ``max_unpool2d``,
dispatched under the JAX package's op names ("max_pool2d",
"avg_pool2d", "adaptive_avg_pool2d", ...; none is on an AMP list).

The pools are ATen's (the JAX package leaves them to XLA's
``reduce_window``).  A channel-last input is handed to ATen as a view
with its channels at axis 1 (``channels_last`` strides: no copy), as the
convolutions do.  Padding takes the convolutions' forms; max pooling
pads with -inf, average pooling with zeros, and ``exclusive`` divides
each window by the count of its positions inside the input.  Where
ATen's pools cannot take the padding (asymmetric, or more than half the
window) the input is padded first.  Adaptive pools use the JAX bins:
output ``i`` of ``o`` over ``n`` inputs spans ``[floor(i·n/o),
ceil((i+1)·n/o))``, ATen's rule too.

Differences by design (ROADMAP §3): ``ceil_mode=True`` raises (the JAX
package ignores it); ``divisor_override`` divides each window's sum, as
paddle does (the JAX package ignores it); ``return_mask`` is ported for
``max_pool2d`` only (the JAX package returns no mask from the others);
for NHWC input its mask, like its output, is channel-last, each entry
the index ``h·W + w`` of the window's maximum within its channel."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...framework.errors import InvalidArgumentError
from ...ops._helpers import to_tensor_like
from ...ops.dispatch import apply
from .conv import (_channels_back, _channels_first, _explicit_pads,
                   _flat_pad, _norm_padding, _norm_tuple)

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "max_unpool2d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _refuse(what):
    raise InvalidArgumentError(
        f"{what} is not ported (the JAX package ignores it; ROADMAP §3)")


def _pool_args(kernel_size, stride, padding, n, ceil_mode):
    if ceil_mode:
        _refuse("pooling with ceil_mode=True")
    ksize = _norm_tuple(kernel_size, n)
    strides = _norm_tuple(stride if stride is not None else kernel_size, n)
    return ksize, strides, _norm_padding(padding, n)


def _native(pads, ksize):
    """ATen's pools take a symmetric pad of at most half the window."""
    return all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ksize))


def _max_core(v, ksize, strides, pad, with_mask):
    """Max pooling of a channels-first ``v``: (out, flat spatial index of
    each maximum in the unpadded input, or None)."""
    n = len(ksize)
    pads = _explicit_pads(pad, v.shape[2:], ksize, strides, (1,) * n)
    pool = _MAX[n]
    if _native(pads, ksize):
        res = pool(v, ksize, strides, tuple(lo for lo, _ in pads),
                   return_indices=with_mask)
        return res if with_mask else (res, None)
    padded = TF.pad(v, _flat_pad(pads), value=-math.inf)
    res = pool(padded, ksize, strides, 0, return_indices=with_mask)
    if not with_mask:
        return res, None
    out, idx = res
    # indices of the padded input -> indices of the input (2-D)
    (lo_h, _), (lo_w, _) = pads
    wp, w = padded.shape[-1], v.shape[-1]
    idx = (idx // wp - lo_h) * w + (idx % wp - lo_w)
    return out, idx


def _avg_core(v, ksize, strides, pad, exclusive, divisor_override):
    n = len(ksize)
    pads = _explicit_pads(pad, v.shape[2:], ksize, strides, (1,) * n)
    pool = _AVG[n]
    extra = {} if n == 1 else {"divisor_override": divisor_override}
    if _native(pads, ksize) and (n > 1 or divisor_override is None):
        return pool(v, ksize, strides, tuple(lo for lo, _ in pads),
                    count_include_pad=not exclusive, **extra)
    flat = _flat_pad(pads)
    total = pool(TF.pad(v, flat), ksize, strides, 0) * math.prod(ksize)
    if divisor_override is not None:
        return total / divisor_override
    if not exclusive:
        return total / math.prod(ksize)
    ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype,
                      device=v.device)
    return total / (pool(TF.pad(ones, flat), ksize, strides, 0)
                    * math.prod(ksize))


def _max_pool(x, kernel_size, stride, padding, ceil_mode, channel_last, n,
              name):
    ksize, strides, pad = _pool_args(kernel_size, stride, padding, n,
                                     ceil_mode)

    def f(v):
        out, _ = _max_core(_channels_first(v, channel_last), ksize, strides,
                           pad, False)
        return _channels_back(out, channel_last)

    return apply(name, f, to_tensor_like(x))


def _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override, channel_last, n, name):
    ksize, strides, pad = _pool_args(kernel_size, stride, padding, n,
                                     ceil_mode)

    def f(v):
        out = _avg_core(_channels_first(v, channel_last), ksize, strides,
                        pad, exclusive, divisor_override)
        return _channels_back(out, channel_last)

    return apply(name, f, to_tensor_like(x))


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    if return_mask:
        _refuse("max_pool1d(return_mask=True)")
    return _max_pool(x, kernel_size, stride, padding, ceil_mode,
                     data_format == "NLC", 1, "max_pool1d")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max pooling over H and W; with ``return_mask`` also the int32 index
    ``h·W + w`` of each window's maximum (no gradient)."""
    if not return_mask:
        return _max_pool(x, kernel_size, stride, padding, ceil_mode,
                         data_format == "NHWC", 2, "max_pool2d")
    ksize, strides, pad = _pool_args(kernel_size, stride, padding, 2,
                                     ceil_mode)
    channel_last = data_format == "NHWC"

    def f(v):
        out, idx = _max_core(_channels_first(v, channel_last), ksize,
                             strides, pad, True)
        return (_channels_back(out, channel_last),
                _channels_back(idx.to(torch.int32), channel_last))

    return tuple(apply("max_pool2d", f, to_tensor_like(x)))


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        _refuse("max_pool3d(return_mask=True)")
    return _max_pool(x, kernel_size, stride, padding, ceil_mode,
                     data_format == "NDHWC", 3, "max_pool3d")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     None, data_format == "NLC", 1, "avg_pool1d")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format == "NHWC", 2,
                     "avg_pool2d")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format == "NDHWC", 3,
                     "avg_pool3d")


def _adaptive_pool(x, output_size, n, channel_last, mode, name):
    x = to_tensor_like(x)
    sizes = ((output_size,) * n if isinstance(output_size, int) or
             output_size is None else tuple(output_size))
    pool = _ADAPTIVE[(mode, n)]

    def f(v):
        v = _channels_first(v, channel_last)
        out_size = tuple(int(v.shape[2 + i]) if o is None else int(o)
                         for i, o in enumerate(sizes))
        return _channels_back(pool(v, out_size if n > 1 else out_size[0]),
                              channel_last)

    return apply(name, f, x)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, False, "avg",
                          "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, data_format == "NHWC", "avg",
                          "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, data_format == "NDHWC", "avg",
                          "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _refuse("adaptive_max_pool1d(return_mask=True)")
    return _adaptive_pool(x, output_size, 1, False, "max",
                          "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _refuse("adaptive_max_pool2d(return_mask=True)")
    return _adaptive_pool(x, output_size, 2, False, "max",
                          "adaptive_max_pool2d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _refuse("adaptive_max_pool3d(return_mask=True)")
    return _adaptive_pool(x, output_size, 3, False, "max",
                          "adaptive_max_pool3d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    """The inverse of ``max_pool2d(return_mask=True)``: each pooled value
    written at the flat spatial index its mask entry names, zeros
    elsewhere (one scatter).  NCHW only, as in the JAX package."""
    if data_format != "NCHW":
        raise ValueError("max_unpool2d: only NCHW is supported")
    ks = _norm_tuple(kernel_size, 2)
    st = _norm_tuple(stride if stride is not None else kernel_size, 2)
    pd = _norm_tuple(padding, 2)

    def f(v, idx):
        N, C, h, w = v.shape
        if output_size is not None:
            H, W = int(output_size[-2]), int(output_size[-1])
        else:
            H = (h - 1) * st[0] - 2 * pd[0] + ks[0]
            W = (w - 1) * st[1] - 2 * pd[1] + ks[1]
        flat = torch.zeros((N, C, H * W), dtype=v.dtype, device=v.device)
        out = flat.scatter(2, idx.reshape(N, C, h * w).long(),
                           v.reshape(N, C, h * w))
        return out.reshape(N, C, H, W)

    return apply("max_unpool2d", f, to_tensor_like(x),
                 to_tensor_like(indices))
