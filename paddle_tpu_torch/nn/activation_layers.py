"""Activation layers — twin of ``paddle_tpu/nn/activation_layers.py``:
one layer per function of ``nn/functional/activation.py`` (its keyword
defaults as the layer's positional arguments), ``Softmax``,
``LogSoftmax``, ``PReLU`` (a learned slope), ``RReLU`` (random in
training) and ``GLU``."""
from __future__ import annotations

from . import functional as F
from . import initializer as init
from .layer import Layer

__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Softsign", "Silu", "Mish",
           "Tanhshrink", "LogSigmoid", "GELU", "ELU", "CELU", "SELU",
           "LeakyReLU", "Hardshrink", "Softshrink", "Hardtanh",
           "Hardsigmoid", "Hardswish", "Swish", "Softplus",
           "ThresholdedReLU", "Maxout", "Softmax", "LogSoftmax", "PReLU",
           "RReLU", "GLU"]


def _simple(fn_name, **defaults):
    class _Act(Layer):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            merged = dict(defaults)
            for key, a in zip(defaults, args):
                merged[key] = a
            merged.update({k: v for k, v in kwargs.items() if k in merged})
            self._kwargs = merged

        def forward(self, x):
            return getattr(F, fn_name)(x, **self._kwargs)

    _Act.__name__ = fn_name
    return _Act


ReLU = _simple("relu")
ReLU6 = _simple("relu6")
Sigmoid = _simple("sigmoid")
Tanh = _simple("tanh")
Softsign = _simple("softsign")
Silu = _simple("silu")
Mish = _simple("mish")
Tanhshrink = _simple("tanhshrink")
LogSigmoid = _simple("log_sigmoid")
GELU = _simple("gelu", approximate=False)
ELU = _simple("elu", alpha=1.0)
CELU = _simple("celu", alpha=1.0)
SELU = _simple("selu")
LeakyReLU = _simple("leaky_relu", negative_slope=0.01)
Hardshrink = _simple("hardshrink", threshold=0.5)
Softshrink = _simple("softshrink", threshold=0.5)
Hardtanh = _simple("hardtanh", min=-1.0, max=1.0)
Hardsigmoid = _simple("hardsigmoid")
Hardswish = _simple("hardswish")
Swish = _simple("swish")
Softplus = _simple("softplus", beta=1.0, threshold=20.0)
ThresholdedReLU = _simple("thresholded_relu", threshold=1.0)
Maxout = _simple("maxout", groups=2, axis=1)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init_value=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_parameters], attr=weight_attr,
            default_initializer=init.Constant(init_value))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, axis=self.axis)
