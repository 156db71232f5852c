"""Common functionals — twins of ``paddle_tpu/nn/functional/common.py``:
``linear``, the dropouts, ``pad``, ``embedding``, ``one_hot``,
``label_smooth``, ``cosine_similarity``, ``bilinear``, ``interpolate``,
the shuffles, ``unfold`` / ``fold``, ``affine_grid`` / ``grid_sample``,
``temporal_shift`` and ``npair_loss``, under the JAX package's op names.

The products are ``torch.matmul``, the gathers, scatters and resizes
plain PyTorch, as the JAX package leaves them to XLA; each follows the
JAX rule, where torch's own mode differs:

- ``interpolate`` "nearest" is ``jax.image.resize``'s half-pixel rule,
  ``floor((i + 0.5) · in / out)`` — torch's ``"nearest-exact"``, not its
  ``"nearest"``;
- "linear" / "bilinear" / "trilinear" / "area" (the reference maps
  "area" to linear) and "bicubic" are ``jax.image.resize``'s separable
  weight matrices: the triangle kernel, or Keys' cubic with a = -0.5
  (torch's bicubic has a = -0.75), normalized, and widened by the
  shrink factor when downsampling (antialiasing: torch's
  ``antialias=True``, which it has for 2-D only);
- ``align_corners=True`` is the reference's linear gather along each
  axis (also for "bicubic"): torch's ``align_corners=True`` linear
  modes; ``align_mode`` is accepted and read by nothing, as there;
- ``one_hot`` gives float32 and a zero row for an id out of range
  (``jax.nn.one_hot``; torch's gives int64 and raises);
- ``cosine_similarity`` clamps the product of the two norms by ``eps``
  (torch clamps each norm);
- ``pad`` takes the full-rank paddle form (``[d0_lo, d0_hi, ...]``) for a
  constant pad of every dim, else the spatial form, last dim first;
  "replicate" is numpy's "edge", "circular" its "wrap";
- ``grid_sample`` "nearest" rounds half to even, "border" clips, and an
  out-of-range tap under "zeros" is dropped by the reference's rule
  (``0 <= y <= H - 1`` and ``0 <= x <= W - 1``, on the tap).

The dropouts draw their masks from the port's generator of the input's
device (``framework.random``), so their bits are not the JAX package's
threefry bits: the keep rate and the scaling are the same, the mask is
not.  ``grid_sample(padding_mode="reflection")``, which the reference
clips like "border", raises."""
from __future__ import annotations

import numpy as np
import torch

from ...framework.errors import InvalidArgumentError
from ...framework.random import generator
from ...ops._helpers import norm_shape, to_tensor_like, value_of
from ...ops.dispatch import apply
from ...sparse_grad import sparse_grads_enabled

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "pad", "zeropad2d", "embedding", "one_hot", "label_smooth",
           "cosine_similarity", "bilinear", "interpolate", "upsample",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "unfold",
           "fold", "affine_grid", "grid_sample", "temporal_shift",
           "npair_loss"]


def linear(x, weight, bias=None, name=None):
    if bias is not None:
        return apply("linear", lambda v, w, b: torch.matmul(v, w) + b,
                     x, weight, bias)
    return apply("linear", torch.matmul, x, weight)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability ``p`` (one draw along the axes
    not in ``axis``, when given) and scale the kept ones by ``1/(1-p)``
    (``mode="upscale_in_train"``); ``"downscale_in_infer"`` keeps them
    as they are and scales by ``1-p`` in eval mode instead.  The bits are
    drawn inside the op from the port's generator, so in a static
    Program every ``Executor.run`` draws anew (the JAX package feeds a
    refreshed key slot for that, ``paddle_tpu/nn/functional/common.py:
    77-85``)."""
    x = to_tensor_like(x)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return apply("dropout_scale", lambda v: v * (1.0 - p), x)
        return x
    if p == 1.0:
        return apply("dropout", torch.zeros_like, x)
    gen = generator(x.place)

    def f(v):
        shape = list(v.shape)
        if axis is not None:
            axes = (axis,) if isinstance(axis, int) else tuple(axis)
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = (torch.rand(shape, generator=gen, device=v.device)
                < 1.0 - p).expand(v.shape)
        kept = v / (1.0 - p) if mode == "upscale_in_train" else v
        return torch.where(keep, kept, torch.zeros_like(v)).to(v.dtype)

    return apply("dropout", f, x)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """One draw per (sample, channel) map."""
    ax = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p=p, axis=list(ax), training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    ax = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p=p, axis=list(ax), training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: a dropped element takes ``-alpha·scale``,
    then the affine ``a·v + b`` keeps the mean and variance."""
    x = to_tensor_like(x)
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772848170429916717
    scale = 1.0507009873554804934193349852946
    alpha_p = -alpha * scale
    gen = generator(x.place)

    def f(v):
        keep = torch.rand(v.shape, generator=gen, device=v.device) < 1.0 - p
        a = (1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
        b = -a * alpha_p * p
        return (a * torch.where(keep, v, torch.full_like(v, alpha_p))
                + b).to(v.dtype)

    return apply("alpha_dropout", f, x)


_PAD_MODES = ("constant", "reflect", "replicate", "circular")


def _torch_pad(v, pairs, mode, value):
    """``v`` padded by ``(lo, hi)`` per dim; a non-constant mode pads the
    trailing dims that carry a pad (torch pads at most three)."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    if mode == "constant":
        return torch.nn.functional.pad(v, flat, value=value)
    # torch's reflect / replicate / circular pad the last k dims of a
    # batched input: move the padded dims last
    dims = [i for i, pr in enumerate(pairs) if pr != (0, 0)]
    if not dims:
        return v
    rest = [i for i in range(v.dim()) if i not in dims]
    perm = rest + dims
    moved = v.permute(perm)
    lead = moved.shape[:len(rest)]
    moved = moved.reshape((-1, 1) + tuple(moved.shape[len(rest):]))
    flat = []
    for d in reversed(dims):
        flat += list(pairs[d])
    out = torch.nn.functional.pad(moved, flat, mode=mode)
    out = out.reshape(tuple(lead) + tuple(out.shape[2:]))
    return out.permute([int(i) for i in np.argsort(perm)])


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad as the reference: ``pad`` of length ``2·ndim`` with
    ``mode="constant"`` is the full-rank form ``[d0_lo, d0_hi, d1_lo,
    ...]``; otherwise it pads the spatial dims, last one first
    (``[left, right, top, bottom, ...]``), dispatched as "pad3d"."""
    x = to_tensor_like(x)
    if mode not in _PAD_MODES:
        raise InvalidArgumentError(f"pad: unknown mode {mode!r}")
    if isinstance(pad, (list, tuple)) and len(pad) == 2 * x.ndim \
            and mode == "constant" and not isinstance(pad[0], (list, tuple)):
        pairs = [(int(pad[2 * i]), int(pad[2 * i + 1]))
                 for i in range(x.ndim)]
        return apply("pad", lambda v: _torch_pad(v, pairs, "constant",
                                                 value), x)
    n_spatial = x.ndim - 2
    pad = [int(value_of(p)) for p in pad]
    spatial = [(pad[2 * i], pad[2 * i + 1]) for i in range(len(pad) // 2)]
    spatial = spatial[::-1]
    while len(spatial) < n_spatial:
        spatial.insert(0, (0, 0))
    if data_format.startswith("NC"):
        pairs = [(0, 0), (0, 0)] + spatial
    else:
        pairs = [(0, 0)] + spatial + [(0, 0)]
    return apply("pad3d", lambda v: _torch_pad(v, pairs, mode, value), x)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """The rows of ``weight`` at the ids ``x``; ids equal to
    ``padding_idx`` read zeros (and pass no gradient).  ``sparse=True``
    gives the weight a row-sparse gradient (reference ``:156-195``): one
    row per id, the ``[vocab, dim]`` dense gradient never formed
    (``sparse_grad.py``), except inside ``sparse_grad.dense_grads()``."""
    x, weight = to_tensor_like(x), to_tensor_like(weight)
    pad_id = None
    if padding_idx is not None:
        pad_id = padding_idx if padding_idx >= 0 else \
            weight.shape[0] + padding_idx
    sparse = sparse and sparse_grads_enabled()

    def f(w, idx):
        if sparse:
            out = torch.nn.functional.embedding(idx.long(), w, sparse=True)
        else:
            out = w[idx.long()]
        if pad_id is not None:
            out = torch.where((idx == pad_id)[..., None],
                              torch.zeros_like(out), out)
        return out

    return apply("lookup_table_v2", f, weight, x)


def one_hot(x, num_classes, name=None):
    """float32 rows, all zero for an id outside ``[0, num_classes)``."""
    x = to_tensor_like(x)
    n = int(value_of(num_classes))

    def f(v):
        classes = torch.arange(n, device=v.device)
        return (v.long()[..., None] == classes).to(torch.float32)

    return apply("one_hot_v2", f, x)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    label = to_tensor_like(label)
    if prior_dist is not None:
        return apply("label_smooth",
                     lambda lab, pd: (1 - epsilon) * lab + epsilon * pd,
                     label, to_tensor_like(prior_dist))
    k = label.shape[-1]
    return apply("label_smooth",
                 lambda lab: (1 - epsilon) * lab + epsilon / k, label)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    def f(a, b):
        dot = torch.sum(a * b, dim=axis)
        na = torch.sqrt(torch.sum(a * a, dim=axis))
        nb = torch.sqrt(torch.sum(b * b, dim=axis))
        return dot / torch.clamp(na * nb, min=eps)

    return apply("cosine_similarity", f, to_tensor_like(x1),
                 to_tensor_like(x2))


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] · W[o] · x2[b] (+ bias)``."""
    def f(a, b, w, *mb):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out + mb[0] if mb else out

    args = [to_tensor_like(x1), to_tensor_like(x2), to_tensor_like(weight)]
    if bias is not None:
        args.append(to_tensor_like(bias))
    return apply("bilinear", f, *args)


# --- resizing -------------------------------------------------------------
def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x):
    """Keys' cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(in_size, out_size, kernel, device):
    """``jax.image.resize``'s ``[in, out]`` weights for one axis: the
    kernel at the half-pixel sample points, widened by the shrink factor
    when downsampling, normalized per output, zero outside the input."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    pos = torch.arange(in_size, dtype=torch.float32, device=device)
    # a product by the host's reciprocal: the card divides by a scalar
    # that way, so the CPU does too
    w = kernel(torch.abs(sample[None, :] - pos[:, None])
               * (1.0 / kernel_scale))
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_kernel(v, axes, sizes, kernel):
    for ax, n in zip(axes, sizes):
        if v.shape[ax] == n:
            continue
        w = _weight_mat(v.shape[ax], n, kernel, v.device).to(v.dtype)
        v = torch.movedim(torch.tensordot(v, w, dims=([ax], [0])), -1, ax)
    return v


def _resize_nearest(v, axes, sizes):
    for ax, n in zip(axes, sizes):
        m = v.shape[ax]
        if m == n:
            continue
        # in f64, so the card's scalar division rounds as the CPU's
        idx = torch.floor((torch.arange(n, dtype=torch.float64,
                                        device=v.device) + 0.5) * m / n)
        v = torch.index_select(v, ax, idx.long())
    return v


def _resize_align_corners(v, axes, sizes):
    for ax, n in zip(axes, sizes):
        m = v.shape[ax]
        if m == n:
            continue
        if n == 1 or m == 1:
            idx = torch.zeros(n, dtype=torch.float32, device=v.device)
        else:   # i (m-1) / (n-1) rounded once, on either device
            idx = (torch.arange(n, dtype=torch.float64, device=v.device)
                   * (m - 1) / (n - 1)).float()
        lo = torch.floor(idx).long()
        hi = torch.clamp(lo + 1, max=m - 1)
        shape = [1] * v.dim()
        shape[ax] = -1
        w = (idx - lo).to(v.dtype).reshape(shape)
        a = torch.index_select(v, ax, lo)
        b = torch.index_select(v, ax, hi)
        v = a * (1 - w) + b * w
    return v


_RESIZE_MODES = {"nearest": "nearest", "bilinear": "linear",
                 "linear": "linear", "trilinear": "linear",
                 "bicubic": "cubic", "area": "linear"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims to ``size`` (or ``int(in · scale)``) by
    the JAX package's rules (see the module docstring)."""
    x = to_tensor_like(x)
    if mode not in _RESIZE_MODES:
        raise InvalidArgumentError(f"interpolate: unknown mode {mode!r}")
    channel_last = not data_format.startswith("NC")
    n_spatial = x.ndim - 2
    spatial = x.shape[1:-1] if channel_last else x.shape[2:]
    if size is not None:
        sizes = size if isinstance(size, (list, tuple)) else [size]
        out_size = tuple(int(value_of(s)) for s in sizes)
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * n_spatial)
        out_size = tuple(int(s * float(value_of(f)))
                         for s, f in zip(spatial, sf))
    axes = (tuple(range(1, x.ndim - 1)) if channel_last
            else tuple(range(2, x.ndim)))
    jmode = _RESIZE_MODES[mode]

    def f(v):
        if jmode == "nearest":
            return _resize_nearest(v, axes, out_size)
        if not v.is_floating_point():
            v = v.float()
        if align_corners:
            return _resize_align_corners(v, axes, out_size)
        kernel = _triangle if jmode == "linear" else _keys_cubic
        return _resize_kernel(v, axes, out_size, kernel)

    return apply("interpolate", f, x)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


# --- shuffles -------------------------------------------------------------
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = int(upscale_factor)

    def f(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            v = v.reshape(n, c // (r * r), r, r, h, w)
            return v.permute(0, 1, 4, 2, 5, 3).reshape(
                n, c // (r * r), h * r, w * r)
        n, h, w, c = v.shape
        v = v.reshape(n, h, w, r, r, c // (r * r))
        return v.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r,
                                                   c // (r * r))

    return apply("pixel_shuffle", f, to_tensor_like(x))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = int(downscale_factor)

    def f(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            v = v.reshape(n, c, h // r, r, w // r, r)
            return v.permute(0, 1, 3, 5, 2, 4).reshape(
                n, c * r * r, h // r, w // r)
        n, h, w, c = v.shape
        v = v.reshape(n, h // r, r, w // r, r, c)
        return v.permute(0, 1, 3, 5, 2, 4).reshape(n, h // r, w // r,
                                                   c * r * r)

    return apply("pixel_unshuffle", f, to_tensor_like(x))


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def f(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            return v.reshape(n, groups, c // groups, h, w).transpose(
                1, 2).reshape(n, c, h, w)
        n, h, w, c = v.shape
        return v.reshape(n, h, w, groups, c // groups).transpose(
            3, 4).reshape(n, h, w, c)

    return apply("channel_shuffle", f, to_tensor_like(x))


# --- im2col ---------------------------------------------------------------
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C·kh·kw, L]``, the reference's patch order.
    ``paddings`` is an int, ``[ph, pw]`` or ``[top, left, bottom,
    right]``."""
    from .conv import _norm_tuple

    k = _norm_tuple(kernel_sizes, 2)
    s = _norm_tuple(strides, 2)
    d = _norm_tuple(dilations, 2)
    if isinstance(paddings, int):
        p = [(paddings, paddings), (paddings, paddings)]
    else:
        pl = list(paddings)
        if len(pl) == 2:
            p = [(pl[0], pl[0]), (pl[1], pl[1])]
        else:
            p = [(pl[0], pl[2]), (pl[1], pl[3])]

    def f(v):
        v = torch.nn.functional.pad(v, [p[1][0], p[1][1], p[0][0], p[0][1]])
        return torch.nn.functional.unfold(v, k, dilation=d, stride=s)

    return apply("unfold", f, to_tensor_like(x))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im: the inverse scatter of ``unfold``, the overlapping patches
    summed in the reference's order (kernel row, then column)."""
    from .conv import _norm_tuple

    out_hw = _norm_tuple(output_sizes, 2)
    k = _norm_tuple(kernel_sizes, 2)
    s = _norm_tuple(strides, 2)
    d = _norm_tuple(dilations, 2)
    pp = (_norm_tuple(paddings, 2) if not isinstance(paddings, int)
          else (paddings, paddings))

    def f(v):
        n, ck, _ = v.shape
        c = ck // (k[0] * k[1])
        h = (out_hw[0] + 2 * pp[0] - (d[0] * (k[0] - 1) + 1)) // s[0] + 1
        w = (out_hw[1] + 2 * pp[1] - (d[1] * (k[1] - 1) + 1)) // s[1] + 1
        cols = v.reshape(n, c, k[0], k[1], h, w)
        out = v.new_zeros((n, c, out_hw[0] + 2 * pp[0],
                           out_hw[1] + 2 * pp[1]))
        for i in range(k[0]):
            for j in range(k[1]):
                hi, wj = i * d[0], j * d[1]
                out[:, :, hi:hi + h * s[0]:s[0],
                    wj:wj + w * s[1]:s[1]] += cols[:, :, i, j]
        return out[:, :, pp[0]:pp[0] + out_hw[0], pp[1]:pp[1] + out_hw[1]]

    return apply("fold", f, to_tensor_like(x))


# --- sampling grids -------------------------------------------------------
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``[N, H, W, 2]`` sample points: the normalized ``(x, y, 1)`` grid
    of ``out_shape`` through each ``[2, 3]`` theta."""
    shp = norm_shape(out_shape)

    def f(th):
        _, _, h, w = shp

        def axis_coords(n):
            if align_corners:
                return torch.linspace(-1.0, 1.0, n, device=th.device)
            return ((torch.arange(n, dtype=torch.float32, device=th.device)
                     * 2 + 1) * (1.0 / n) - 1.0)

        gy, gx = torch.meshgrid(axis_coords(h), axis_coords(w),
                                indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
        return torch.einsum("hwi,nji->nhwj", base.to(th.dtype), th)

    return apply("affine_grid", f, to_tensor_like(theta))


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x [N, C, H, W]`` at ``grid [N, Ho, Wo, 2]`` (x, y in
    [-1, 1]): bilinear or nearest, "zeros" or "border" outside."""
    if padding_mode not in ("zeros", "border"):
        raise InvalidArgumentError(
            f"grid_sample(padding_mode={padding_mode!r}): the reference "
            "clips it like 'border' (ROADMAP \"Known facts about the "
            "reference\"); use 'border'")

    def f(v, g):
        n, _, h, w = v.shape

        def unnorm(c, size):
            if align_corners:
                return (c + 1) * (size - 1) / 2
            return ((c + 1) * size - 1) / 2

        gx = unnorm(g[..., 0], w)
        gy = unnorm(g[..., 1], h)
        x0, y0 = torch.floor(gx), torch.floor(gy)
        x1, y1 = x0 + 1, y0 + 1
        batch = torch.arange(n, device=v.device)[:, None, None]

        def sample(yy, xx):
            yi = torch.clamp(yy, 0, h - 1).long()
            xi = torch.clamp(xx, 0, w - 1).long()
            out = v.permute(0, 2, 3, 1)[batch, yi, xi]      # N,Ho,Wo,C
            if padding_mode == "zeros":
                valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
                out = out * valid[..., None].to(out.dtype)
            return out

        if mode == "nearest":
            return sample(torch.round(gy), torch.round(gx)).permute(
                0, 3, 1, 2)
        wa = (x1 - gx) * (y1 - gy)
        wb = (x1 - gx) * (gy - y0)
        wc = (gx - x0) * (y1 - gy)
        wd = (gx - x0) * (gy - y0)
        out = (sample(y0, x0) * wa[..., None] + sample(y1, x0) * wb[..., None]
               + sample(y0, x1) * wc[..., None]
               + sample(y1, x1) * wd[..., None])
        return out.permute(0, 3, 1, 2).to(v.dtype)

    return apply("grid_sampler", f, to_tensor_like(x), to_tensor_like(grid))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """Shift a quarter of the channels one segment back, a quarter one
    forward (zeros at the ends)."""
    def f(v):
        nt, c, h, w = v.shape
        v5 = v.reshape(nt // seg_num, seg_num, c, h, w)
        c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
        back = torch.cat([v5[:, 1:, :c1], torch.zeros_like(v5[:, :1, :c1])],
                         dim=1)
        fwd = torch.cat([torch.zeros_like(v5[:, :1, c1:c2]),
                         v5[:, :-1, c1:c2]], dim=1)
        return torch.cat([back, fwd, v5[:, :, c2:]], dim=2).reshape(
            nt, c, h, w)

    return apply("temporal_shift", f, to_tensor_like(x))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    from . import loss as _loss

    return _loss.npair_loss(anchor, positive, labels, l2_reg)
