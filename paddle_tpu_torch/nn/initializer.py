"""Weight initializers — the subset of ``paddle_tpu/nn/initializer.py``
the ported layers default to, with the same names, fans and
distributions.  Each fills a Parameter in place from the CPU generator
of ``framework.random`` (drawn in float32, then copied to the
parameter's device and dtype), so ``seed(s)`` gives the same weights on
the CPU and on the card.  The draws are not threefry's: parity tests
copy paddle_tpu's weights across instead."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.random import generator

__all__ = ["Initializer", "Constant", "Assign", "Normal", "Uniform",
           "XavierNormal", "XavierUniform"]


def _fans(shape):
    """Paddle's fans: a 2-D weight is [in, out]; a conv weight
    [out_c, in_c, *k]."""
    shape = tuple(shape)
    if len(shape) < 2:
        fan_in = fan_out = int(shape[0]) if shape else 1
    elif len(shape) == 2:
        fan_in, fan_out = int(shape[0]), int(shape[1])
    else:
        receptive = int(np.prod(shape[2:]))
        fan_in = int(shape[1]) * receptive
        fan_out = int(shape[0]) * receptive
    return fan_in, fan_out


def _fill(param, host: torch.Tensor):
    with torch.no_grad():
        param._value.copy_(host.to(param._value.dtype))
    return param


class Initializer:
    def __call__(self, param, block=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, param, block=None):
        with torch.no_grad():
            param._value.fill_(self.value)
        return param


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, param, block=None):
        arr = np.asarray(self.value.numpy() if hasattr(self.value, "numpy")
                         else self.value)
        return _fill(param, torch.from_numpy(
            np.array(arr, np.float32)).reshape(param._value.shape))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, param, block=None):
        v = torch.randn(tuple(param._value.shape), generator=generator(),
                        dtype=torch.float32)
        return _fill(param, v * self.std + self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, param, block=None):
        v = torch.rand(tuple(param._value.shape), generator=generator(),
                       dtype=torch.float32)
        return _fill(param, v * (self.high - self.low) + self.low)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        fi, fo = _fans(param._value.shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(param)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        fi, fo = _fans(param._value.shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(param)
