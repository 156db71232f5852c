"""Convolutions — twin of ``paddle_tpu/nn/functional/conv.py``:
``conv1d/2d/3d``, their transposes and ``deformable_conv``, dispatched
as "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
"conv3d_transpose" and "deformable_conv" (the first four and
"conv2d_transpose" are on the AMP white list, as in the JAX package).

The convolutions are ATen's (cuDNN on the card), as the JAX package
leaves them to XLA; the bias is added after, as there.  Weights keep
paddle's layout in every data format: ``[out, in/groups, *k]``, and
``[in, out/groups, *k]`` for a transpose.  A channel-last input
(``NLC``, ``NHWC``, ``NDHWC``) is handed to ATen as a view with its
channels moved to axis 1 — a contiguous ``[N, H, W, C]`` tensor seen as
``[N, C, H, W]`` has the ``channels_last`` strides, so cuDNN runs its
NHWC kernels on it and no layer copies it — and the result is viewed
back.  A channel-last ``Conv2D`` keeps its weight in ``channels_last``
memory (``nn/conv_layers.py``) so that cuDNN need not copy it either.

Padding: an int, one per spatial axis, ``(lo, hi)`` pairs (flat or
nested, also with the batch and channel axes' zero pairs), or
``"SAME"`` / ``"VALID"`` as XLA computes them (``SAME``: output
``ceil(in / stride)``, the odd pad at the end).  Symmetric padding goes
to ATen as it is; asymmetric padding pads the input first.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...ops._helpers import to_tensor_like
from ...ops.dispatch import apply

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "deformable_conv"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _norm_tuple(v, n):
    if isinstance(v, (int, float)):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    if len(v) == 1:
        return v * n
    return v


def _norm_padding(padding, n):
    """``"SAME"``, ``"VALID"`` or ``[(lo, hi)] * n`` (the JAX package's
    ``_norm_padding``)."""
    if isinstance(padding, str):
        p = padding.upper()
        if p in ("SAME", "VALID"):
            return p
        raise ValueError(f"unknown padding {padding!r}")
    if isinstance(padding, (int, float)):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, (int, float))
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    if len(padding) == n and all(isinstance(p, (list, tuple))
                                 for p in padding):
        return [tuple(int(i) for i in p) for p in padding]
    if len(padding) == n + 2:
        return [tuple(int(i) for i in p) for p in padding[2:]]
    raise ValueError(f"cannot interpret padding {padding!r}")


def _explicit_pads(pad, spatial, ksize, stride, dilation):
    """``[(lo, hi)]`` per spatial axis for ``pad`` on inputs of the
    given spatial sizes (XLA's ``SAME`` and ``VALID``)."""
    if pad == "VALID":
        return [(0, 0)] * len(spatial)
    if pad == "SAME":
        out = []
        for size, k, s, d in zip(spatial, ksize, stride, dilation):
            k_eff = (k - 1) * d + 1
            total = max((math.ceil(size / s) - 1) * s + k_eff - size, 0)
            out.append((total // 2, total - total // 2))
        return out
    return list(pad)


def _flat_pad(pads):
    """``TF.pad``'s argument (last axis first) for ``[(lo, hi)]``."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _channels_first(v, channel_last):
    return v.movedim(-1, 1) if channel_last else v


def _channels_back(v, channel_last):
    return v.movedim(1, -1) if channel_last else v


def _add_bias(out, maybe_b):
    if maybe_b:
        out = out + maybe_b[0].reshape((1, -1) + (1,) * (out.dim() - 2))
    return out


def _conv_nd(x, weight, bias, stride, padding, dilation, groups,
             channel_last, n, name):
    x, weight = to_tensor_like(x), to_tensor_like(weight)
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    ksize = tuple(weight.shape[2:])
    pad = _norm_padding(padding, n)
    conv = _CONV[n]

    def f(v, w, *maybe_b):
        v = _channels_first(v, channel_last)
        pads = _explicit_pads(pad, v.shape[2:], ksize, stride, dilation)
        if all(lo == hi for lo, hi in pads):
            out = conv(v, w, None, stride, tuple(lo for lo, _ in pads),
                       dilation, groups)
        else:
            out = conv(TF.pad(v, _flat_pad(pads)), w, None, stride, 0,
                       dilation, groups)
        return _channels_back(_add_bias(out, maybe_b), channel_last)

    args = [x, weight] + ([to_tensor_like(bias)] if bias is not None else [])
    return apply(name, f, *args)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format == "NLC", 1, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format == "NHWC", 2, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format == "NDHWC", 3, "conv3d")


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, channel_last, n, name):
    """The transposed convolution of the JAX package: the full output
    (ATen with no padding), then ``lo`` cropped at the start of each
    axis and ``hi - output_padding`` at its end (a negative crop pads
    zeros: positions no input reaches).  ``output_size`` is ignored, as
    there."""
    x, weight = to_tensor_like(x), to_tensor_like(weight)
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    ksize = tuple(weight.shape[2:])
    pad = _norm_padding(padding, n)
    out_pad = (_norm_tuple(output_padding, n) if output_padding is not None
               else (0,) * n)
    if isinstance(pad, str):
        if pad == "VALID":
            pads = [(0, 0)] * n
        else:
            pads = []
            for k, s, d in zip(ksize, stride, dilation):
                total = (k - 1) * d + 1 - s
                lo = total // 2
                pads.append((max(lo, 0), max(total - lo, 0)))
    else:
        pads = list(pad)
    conv_t = _CONV_T[n]
    crop = [(-lo, -hi + op) for (lo, hi), op in zip(pads, out_pad)]

    def f(v, w, *maybe_b):
        v = _channels_first(v, channel_last)
        out = conv_t(v, w, None, stride, 0, 0, groups, dilation)
        if any(c != (0, 0) for c in crop):
            out = TF.pad(out, _flat_pad(crop))
        return _channels_back(_add_bias(out, maybe_b), channel_last)

    args = [x, weight] + ([to_tensor_like(bias)] if bias is not None else [])
    return apply(name, f, *args)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups,
                              data_format == "NLC", 1, "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups,
                              data_format == "NHWC", 2, "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups,
                              data_format == "NDHWC", 3, "conv3d_transpose")


def deformable_conv(x, offset, mask, weight, bias=None, stride=1,
                    padding=0, dilation=1, deformable_groups=1, groups=1,
                    im2col_step=1, name=None):
    """Deformable convolution v1 / v2 in plain PyTorch (the JAX
    package's is plain JAX): each kernel tap samples ``x`` bilinearly at
    its grid position plus a learned offset (zero outside the image),
    ``mask`` (v2) scales each sample, then a grouped product with the
    weight.  x ``[N, C, H, W]``; offset ``[N, 2·dg·kh·kw, oh, ow]``;
    mask ``[N, dg·kh·kw, oh, ow]`` or None; weight ``[M, C/groups, kh,
    kw]``."""
    s = _norm_tuple(stride, 2)
    p = _norm_tuple(padding, 2)
    d = _norm_tuple(dilation, 2)
    dg, G = int(deformable_groups), int(groups)
    has_mask, has_bias = mask is not None, bias is not None

    def f(v, ofs, wv, *rest):
        mk = rest[0] if has_mask else None
        bv = rest[-1] if has_bias else None
        N, C, H, W = v.shape
        M, Cg, kh, kw = wv.shape
        oh = (H + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
        ow = (W + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
        dev = v.device
        base_y = (torch.arange(oh, device=dev) * s[0] - p[0])[:, None]
        base_x = (torch.arange(ow, device=dev) * s[1] - p[1])[None, :]
        cpg = C // dg
        n_idx = torch.arange(N, device=dev)[:, None, None, None]
        c_idx = torch.arange(cpg, device=dev)[None, :, None, None]
        cols = []
        for ky in range(kh):
            for kx in range(kw):
                t = ky * kw + kx
                samps = []
                for gd in range(dg):
                    tt = gd * kh * kw + t
                    sy = base_y[None] + ky * d[0] + ofs[:, 2 * tt]
                    sx = base_x[None] + kx * d[1] + ofs[:, 2 * tt + 1]
                    y0 = torch.floor(sy).to(torch.int64)
                    x0 = torch.floor(sx).to(torch.int64)
                    fy, fx = sy - y0, sx - x0
                    vc = v[:, gd * cpg:(gd + 1) * cpg]

                    def g(yy, xx):
                        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                        val = vc[n_idx, c_idx, yy.clamp(0, H - 1)[:, None],
                                 xx.clamp(0, W - 1)[:, None]]
                        return torch.where(ok[:, None], val,
                                           torch.zeros_like(val))

                    samp = (g(y0, x0) * ((1 - fy) * (1 - fx))[:, None]
                            + g(y0, x0 + 1) * ((1 - fy) * fx)[:, None]
                            + g(y0 + 1, x0) * (fy * (1 - fx))[:, None]
                            + g(y0 + 1, x0 + 1) * (fy * fx)[:, None])
                    if mk is not None:
                        samp = samp * mk[:, tt][:, None]
                    samps.append(samp)
                cols.append(torch.cat(samps, dim=1))      # [N, C, oh, ow]
        colmat = torch.stack(cols, dim=2)                 # [N, C, kh·kw, ...]
        mpg = M // G
        outs = [torch.einsum("nckhw,mck->nmhw",
                             colmat[:, gg * Cg:(gg + 1) * Cg],
                             wv[gg * mpg:(gg + 1) * mpg].reshape(
                                 mpg, Cg, kh * kw))
                for gg in range(G)]
        out = torch.cat(outs, dim=1)
        if bv is not None:
            out = out + bv.reshape(1, M, 1, 1)
        return out

    args = [to_tensor_like(x), to_tensor_like(offset), to_tensor_like(weight)]
    if has_mask:
        args.append(to_tensor_like(mask))
    if has_bias:
        args.append(to_tensor_like(bias))
    return apply("deformable_conv", f, *args)
