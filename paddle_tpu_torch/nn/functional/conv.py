"""``conv2d`` — twin of ``paddle_tpu/nn/functional/conv.py:104``: paddle's
weight layout ``[out_c, in_c/groups, kh, kw]``, NCHW data, dispatched as
"conv2d" (AMP white list).  The convolution is ATen's (cuDNN on the
card), as the JAX package leaves it to XLA; the bias is added after it,
as there."""
from __future__ import annotations

import torch.nn.functional as TF

from ...framework.errors import InvalidArgumentError
from ...ops.dispatch import apply

__all__ = ["conv2d"]


def _pair(v):
    if isinstance(v, (int, float)):
        return (int(v),) * 2
    v = tuple(int(i) for i in v)
    return v * 2 if len(v) == 1 else v


def _padding(padding):
    """torch's padding from paddle's: an int, ``[ph, pw]`` or
    ``"SAME"``/``"VALID"``."""
    if isinstance(padding, str):
        p = padding.upper()
        if p not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        return p.lower()
    pads = _pair(padding)
    if len(pads) != 2:
        raise InvalidArgumentError(
            f"conv2d padding {padding!r} is not ported yet (ROADMAP queue 1 "
            "item 8)")
    return pads


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    if data_format != "NCHW":
        raise InvalidArgumentError(
            f"conv2d data_format={data_format!r} is not ported yet "
            "(ROADMAP queue 1 item 8)")
    stride, dilation, pad = _pair(stride), _pair(dilation), _padding(padding)

    def f(v, w, *maybe_b):
        out = TF.conv2d(v, w, None, stride, pad, dilation, groups)
        if maybe_b:
            out = out + maybe_b[0].reshape(1, -1, 1, 1)
        return out

    if bias is not None:
        return apply("conv2d", f, x, weight, bias)
    return apply("conv2d", f, x, weight)
