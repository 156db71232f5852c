"""``linear``, ``dropout`` and ``embedding`` — twins of
``paddle_tpu/nn/functional/common.py``'s, dispatched as "linear" (AMP
white list), "dropout" and "lookup_table_v2".

The product is ``torch.matmul``, as the JAX package leaves it to XLA.
Dropout draws its mask from the port's generator of the input's device
(``framework.random``), so its bits are not the JAX package's threefry
bits: the keep rate and the scaling are the same, the mask is not."""
from __future__ import annotations

import torch

from ...framework.errors import InvalidArgumentError
from ...framework.random import generator
from ...ops._helpers import to_tensor_like
from ...ops.dispatch import apply

__all__ = ["linear", "dropout", "embedding"]


def linear(x, weight, bias=None, name=None):
    if bias is not None:
        return apply("linear", lambda v, w, b: torch.matmul(v, w) + b,
                     x, weight, bias)
    return apply("linear", torch.matmul, x, weight)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability ``p`` (one draw along the axes
    not in ``axis``, when given) and scale the kept ones by ``1/(1-p)``
    (``mode="upscale_in_train"``); ``"downscale_in_infer"`` keeps them
    as they are and scales by ``1-p`` in eval mode instead."""
    x = to_tensor_like(x)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return apply("dropout_scale", lambda v: v * (1.0 - p), x)
        return x
    if p == 1.0:
        return apply("dropout", torch.zeros_like, x)
    gen = generator(x.place)

    def f(v):
        shape = list(v.shape)
        if axis is not None:
            axes = (axis,) if isinstance(axis, int) else tuple(axis)
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = (torch.rand(shape, generator=gen, device=v.device)
                < 1.0 - p).expand(v.shape)
        kept = v / (1.0 - p) if mode == "upscale_in_train" else v
        return torch.where(keep, kept, torch.zeros_like(v)).to(v.dtype)

    return apply("dropout", f, x)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """The rows of ``weight`` at the ids ``x``; ids equal to
    ``padding_idx`` read zeros (and pass no gradient).  The gradient is
    dense; ``sparse=True`` (row-sparse gradients) is not ported."""
    if sparse:
        raise InvalidArgumentError(
            "embedding(sparse=True) is not ported yet (ROADMAP queue 1 "
            "item 8)")
    x, weight = to_tensor_like(x), to_tensor_like(weight)
    pad = None
    if padding_idx is not None:
        pad = padding_idx if padding_idx >= 0 else \
            weight.shape[0] + padding_idx

    def f(w, idx):
        out = w[idx.long()]
        if pad is not None:
            out = torch.where((idx == pad)[..., None], torch.zeros_like(out),
                              out)
        return out

    return apply("lookup_table_v2", f, weight, x)
