"""Activations — twin of ``paddle_tpu/nn/functional/activation.py``,
every function dispatched under the JAX package's op name ("relu",
"relu6", "brelu" for ``hardtanh``, "hard_swish", ...), in plain PyTorch
with the JAX package's formulas.

``gelu`` also takes a plain torch tensor and returns one: the torch-module
``GPTModel`` (``text/models.py``) calls it so.  ``rrelu`` and
``gumbel_softmax`` draw from the port's generator of the input's device
(``framework.random``), so their draws are not the JAX package's."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework.dtype import convert_dtype
from ...framework.random import generator
from ...ops._helpers import to_tensor_like
from ...ops.dispatch import apply

__all__ = ["relu", "relu6", "sigmoid", "tanh", "softsign", "silu", "mish",
           "tanhshrink", "log_sigmoid", "gelu", "leaky_relu", "elu", "celu",
           "selu", "hardshrink", "softshrink", "hardtanh", "hardsigmoid",
           "hardswish", "swish", "softplus", "maxout", "prelu", "rrelu",
           "thresholded_relu", "softmax", "log_softmax", "glu",
           "gumbel_softmax"]


def _softplus(v):
    """``log(1 + exp(v))`` as ``jax.nn.softplus``: ``logaddexp(v, 0)``."""
    return torch.logaddexp(v, torch.zeros_like(v))


def _unop(op_name, fn):
    def op(x, name=None):
        return apply(op_name, fn, to_tensor_like(x))

    op.__name__ = op_name
    return op


relu = _unop("relu", torch.relu)
relu6 = _unop("relu6", lambda v: torch.clamp(v, 0.0, 6.0))
sigmoid = _unop("sigmoid", torch.sigmoid)
tanh = _unop("tanh", torch.tanh)
softsign = _unop("softsign", lambda v: v / (1 + v.abs()))
silu = _unop("silu", TF.silu)
mish = _unop("mish", lambda v: v * torch.tanh(_softplus(v)))
tanhshrink = _unop("tanh_shrink", lambda v: v - torch.tanh(v))
log_sigmoid = _unop("logsigmoid", TF.logsigmoid)


def gelu(x, approximate=False, name=None):
    """GELU: the erf form, or with ``approximate`` the tanh form
    ``0.5·x·(1 + tanh(sqrt(2/pi)·(x + 0.044715·x³)))``."""
    from ...text.generation import _gelu

    fn = (lambda v: TF.gelu(v, approximate="tanh")) if approximate else _gelu
    if isinstance(x, torch.Tensor):
        return fn(x)
    return apply("gelu", fn, to_tensor_like(x))


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply("leaky_relu",
                 lambda v: torch.where(v >= 0, v, negative_slope * v),
                 to_tensor_like(x))


def elu(x, alpha=1.0, name=None):
    return apply("elu", lambda v: torch.where(v > 0, v,
                                              alpha * torch.expm1(v)),
                 to_tensor_like(x))


def celu(x, alpha=1.0, name=None):
    return apply("celu", lambda v: torch.where(
        v > 0, v, alpha * torch.expm1(v / alpha)), to_tensor_like(x))


def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    return apply("selu", lambda v: scale * torch.where(
        v > 0, v, alpha * torch.expm1(v)), to_tensor_like(x))


def hardshrink(x, threshold=0.5, name=None):
    return apply("hard_shrink", lambda v: torch.where(
        v.abs() > threshold, v, torch.zeros_like(v)), to_tensor_like(x))


def softshrink(x, threshold=0.5, name=None):
    return apply("softshrink", lambda v: torch.where(
        v > threshold, v - threshold,
        torch.where(v < -threshold, v + threshold, torch.zeros_like(v))),
        to_tensor_like(x))


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply("brelu", lambda v: torch.clamp(v, min, max),
                 to_tensor_like(x))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply("hard_sigmoid",
                 lambda v: torch.clamp(v * slope + offset, 0.0, 1.0),
                 to_tensor_like(x))


def hardswish(x, name=None):
    return apply("hard_swish",
                 lambda v: v * torch.clamp(v + 3.0, 0.0, 6.0) / 6.0,
                 to_tensor_like(x))


def swish(x, name=None):
    return apply("swish", TF.silu, to_tensor_like(x))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply("softplus", lambda v: torch.where(
        beta * v > threshold, v, (1.0 / beta) * _softplus(beta * v)).to(
            v.dtype), to_tensor_like(x))


def maxout(x, groups, axis=1, name=None):
    def f(v):
        ax = axis % v.dim()
        c = v.shape[ax]
        shape = v.shape[:ax] + (c // groups, groups) + v.shape[ax + 1:]
        return v.reshape(shape).amax(dim=ax + 1)

    return apply("maxout", f, to_tensor_like(x))


def prelu(x, weight, data_format="NCHW", name=None):
    def f(v, w):
        if w.numel() == 1:
            wb = w.reshape(())
        else:
            shape = [1] * v.dim()
            shape[1 if data_format[1] == "C" else v.dim() - 1] = -1
            wb = w.reshape(shape)
        return torch.where(v >= 0, v, wb * v).to(v.dtype)

    return apply("prelu", f, to_tensor_like(x), to_tensor_like(weight))


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=True,
          name=None):
    """Randomized leaky ReLU: in training each negative entry is scaled by
    a draw from U(lower, upper); in eval by their mean."""
    x = to_tensor_like(x)
    if training:
        gen = generator(x.place)

        def f(v):
            a = (torch.rand(v.shape, generator=gen, device=v.device)
                 * (upper - lower) + lower).to(v.dtype)
            return torch.where(v >= 0, v, a * v)

        return apply("rrelu", f, x)
    mid = (lower + upper) / 2.0
    return apply("rrelu", lambda v: torch.where(v >= 0, v, mid * v).to(
        v.dtype), x)


def thresholded_relu(x, threshold=1.0, name=None):
    return apply("thresholded_relu", lambda v: torch.where(
        v > threshold, v, torch.zeros_like(v)), to_tensor_like(x))


def softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype) if dtype is not None else None
    return apply("softmax", lambda v: torch.softmax(
        v if d is None else v.to(d), dim=axis), to_tensor_like(x))


def log_softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype) if dtype is not None else None
    return apply("log_softmax", lambda v: torch.log_softmax(
        v if d is None else v.to(d), dim=axis), to_tensor_like(x))


def glu(x, axis=-1, name=None):
    return apply("glu", lambda v: TF.glu(v, dim=axis), to_tensor_like(x))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + Gumbel noise) / temperature``; ``hard`` returns
    the one-hot of its maximum with the soft gradient."""
    x = to_tensor_like(x)
    gen = generator(x.place)

    def f(v):
        dt = v.dtype if v.is_floating_point() else torch.float32
        u = torch.rand(v.shape, generator=gen, device=v.device).to(dt)
        tiny = torch.finfo(dt).tiny
        e = (-torch.log(u.clamp_min(tiny))).clamp_min(tiny)
        g = -torch.log(e)
        y = torch.softmax((v + g) / temperature, dim=axis)
        if hard:
            one_hot = (y == y.amax(dim=axis, keepdim=True)).to(y.dtype)
            y = (one_hot - y).detach() + y
        return y

    return apply("gumbel_softmax", f, x)
