"""Pooling layers — twin of ``paddle_tpu/nn/pool_layers.py``: max and
average pooling in 1, 2 and 3 dimensions, the adaptive pools and
``MaxUnPool2D``, over ``nn/functional/pooling.py``."""
from __future__ import annotations

from . import functional as F
from .layer import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "MaxUnPool2D"]


class _Pool(Layer):
    def __init__(self, kernel_size=None, stride=None, padding=0, **kw):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.kw = kw


class MaxPool1D(_Pool):
    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            **self.kw)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode,
                         data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kw)


class MaxPool3D(_Pool):
    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            **self.kw)


class AvgPool1D(_Pool):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            **self.kw)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode=ceil_mode,
                         exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kw)


class AvgPool3D(_Pool):
    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            **self.kw)


class _Adaptive(Layer):
    def __init__(self, output_size, **kw):
        super().__init__()
        self.output_size = output_size
        self.kw = kw


class AdaptiveAvgPool1D(_Adaptive):
    def __init__(self, output_size, name=None):
        super().__init__(output_size)

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_Adaptive):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format=data_format)

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, **self.kw)


class AdaptiveAvgPool3D(_Adaptive):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format=data_format)

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, **self.kw)


class AdaptiveMaxPool1D(_Adaptive):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask=return_mask)

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, **self.kw)


class AdaptiveMaxPool2D(_Adaptive):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask=return_mask)

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, **self.kw)


class AdaptiveMaxPool3D(_Adaptive):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask=return_mask)

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, **self.kw)


class MaxUnPool2D(Layer):
    """The inverse of ``MaxPool2D(return_mask=True)``."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.data_format, self.output_size = data_format, output_size

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self.kernel_size, self.stride,
                              self.padding, output_size=self.output_size,
                              data_format=self.data_format)
