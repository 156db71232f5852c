"""Conv layers — twin of ``paddle_tpu/nn/conv_layers.py``: ``Conv1D``,
``Conv2D``, ``Conv3D`` and their transposes.  The weight is paddle's
``[out, in/groups, *k]`` (``[in, out/groups, *k]`` for a transpose),
the bias ``[out]``, both drawn from ``Uniform(±1/sqrt(fan_in))``.

A channel-last ``Conv2D`` / ``Conv3D`` (``NHWC``, ``NDHWC``) keeps its
weight in ``channels_last`` memory: the same shape and values, strides
that match the input view cuDNN's NHWC kernels read, so a step copies
neither (``nn/functional/conv.py``).  ``set_state_dict`` and the
optimizer update it in place and keep those strides."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError
from . import functional as F
from . import initializer as init
from .layer import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]

_CHANNELS_LAST = {"NHWC": torch.channels_last,
                  "NDHWC": torch.channels_last_3d}


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, dims, transposed=False,
                 output_padding=0):
        super().__init__()
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        if padding_mode != "zeros":
            raise InvalidArgumentError(
                f"padding_mode={padding_mode!r} is not ported (the JAX "
                "package ignores it; ROADMAP queue 1 item 8)")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._groups = groups
        self._kernel_size = ((int(kernel_size),) * dims
                             if isinstance(kernel_size, (int, float))
                             else tuple(int(k) for k in kernel_size))
        self._stride, self._padding = stride, padding
        self._dilation, self._data_format = dilation, data_format
        self._output_padding = output_padding
        if transposed:
            w_shape = [in_channels, out_channels // groups]
        else:
            w_shape = [out_channels, in_channels // groups]
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            shape=w_shape + list(self._kernel_size), attr=weight_attr,
            default_initializer=init.Uniform(-bound, bound))
        fmt = _CHANNELS_LAST.get(data_format)
        if fmt is not None and not transposed:
            w = self.weight._value
            self.weight._value = w.detach().contiguous(
                memory_format=fmt).requires_grad_(w.requires_grad)
        self.bias = self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True,
            default_initializer=init.Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 1)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 2)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 3)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 1, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation,
            output_size, self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 2, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation,
            output_size, self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 3, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation,
            output_size, self._data_format)
