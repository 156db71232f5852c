"""``max_pool2d`` — twin of ``paddle_tpu/nn/functional/pooling.py:58``,
dispatched as "max_pool2d"; ATen's pooling (the JAX package leaves it to
XLA's reduce_window).  Padding counts as -inf.  ``return_mask``,
``ceil_mode`` and NHWC are not ported (ROADMAP queue 1 item 8):
paddle_tpu ignores ``ceil_mode``, so the port refuses it."""
from __future__ import annotations

import torch.nn.functional as TF

from ...framework.errors import InvalidArgumentError
from ...ops.dispatch import apply
from .conv import _pair

__all__ = ["max_pool2d"]


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask or ceil_mode or data_format != "NCHW":
        raise InvalidArgumentError(
            "max_pool2d with return_mask, ceil_mode or NHWC is not ported "
            "yet (ROADMAP queue 1 item 8)")
    if isinstance(padding, str):
        raise InvalidArgumentError(
            "max_pool2d with string padding is not ported yet (ROADMAP "
            "queue 1 item 8)")
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    pad = _pair(padding)
    return apply("max_pool2d",
                 lambda v: TF.max_pool2d(v, ks, st, pad), x)
