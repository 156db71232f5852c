"""``linear`` — twin of ``paddle_tpu/nn/functional/common.py``'s: ``x @ W
+ b`` with W ``[in, out]``, dispatched as "linear" (AMP white list).
The product is ``torch.matmul``, as the JAX package leaves it to XLA."""
from __future__ import annotations

import torch

from ...ops.dispatch import apply

__all__ = ["linear"]


def linear(x, weight, bias=None, name=None):
    if bias is not None:
        return apply("linear", lambda v, w, b: torch.matmul(v, w) + b,
                     x, weight, bias)
    return apply("linear", torch.matmul, x, weight)
