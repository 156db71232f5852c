"""Activation layers — twin of ``paddle_tpu/nn/activation_layers.py``'s
``ReLU``."""
from __future__ import annotations

from . import functional as F
from .layer import Layer

__all__ = ["ReLU"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)
