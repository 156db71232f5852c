"""Conv2D — twin of ``paddle_tpu/nn/conv_layers.py:67``: weight
``[out_c, in_c/groups, kh, kw]`` and bias ``[out_c]``, both drawn from
``Uniform(±1/sqrt(fan_in))``."""
from __future__ import annotations

import numpy as np

from . import functional as F
from . import initializer as init
from .layer import Layer

__all__ = ["Conv2D"]


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        if padding_mode != "zeros":
            from ..framework.errors import InvalidArgumentError

            raise InvalidArgumentError(
                f"padding_mode={padding_mode!r} is not ported yet (ROADMAP "
                "queue 1 item 8)")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._groups = groups
        ks = ((int(kernel_size),) * 2 if isinstance(kernel_size, int)
              else tuple(int(k) for k in kernel_size))
        self._kernel_size = ks
        self._stride, self._padding = stride, padding
        self._dilation, self._data_format = dilation, data_format
        fan_in = in_channels // groups * int(np.prod(ks))
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups, *ks],
            attr=weight_attr, default_initializer=init.Uniform(-bound, bound))
        self.bias = self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True,
            default_initializer=init.Uniform(-bound, bound))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
