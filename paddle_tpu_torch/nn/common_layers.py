"""Common layers — twins of ``paddle_tpu/nn/common_layers.py``'s
``Linear`` (``:14``) and ``Flatten`` (``:68``)."""
from __future__ import annotations

from . import functional as F
from . import initializer as init
from .layer import Layer

__all__ = ["Linear", "Flatten"]


class Linear(Layer):
    """``y = x @ W + b`` with paddle's weight layout ``[in_features,
    out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features, self._out_features = in_features, out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=init.XavierNormal())
        self.bias = self.create_parameter(
            shape=[out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        from ..ops.manipulation import flatten

        return flatten(x, self.start_axis, self.stop_axis)
