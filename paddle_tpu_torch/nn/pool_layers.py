"""MaxPool2D — twin of ``paddle_tpu/nn/pool_layers.py:20``."""
from __future__ import annotations

from . import functional as F
from .layer import Layer

__all__ = ["MaxPool2D"]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.kw = dict(return_mask=return_mask, ceil_mode=ceil_mode,
                       data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kw)
