"""``relu`` — twin of ``paddle_tpu/nn/functional/activation.py``'s,
dispatched as "relu"."""
from __future__ import annotations

import torch

from ...ops.dispatch import apply

__all__ = ["relu"]


def relu(x, name=None):
    return apply("relu", torch.relu, x)
