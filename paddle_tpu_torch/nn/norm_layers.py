"""``LayerNorm`` — twin of ``paddle_tpu/nn/norm_layers.py:105``.  The
batch, group and instance norms are not ported yet (ROADMAP queue 1
item 8)."""
from __future__ import annotations

from . import functional as F
from . import initializer as init
from .layer import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    """Normalize over the trailing ``normalized_shape`` axes; ``weight``
    starts at one and ``bias`` at zero (``weight_attr`` / ``bias_attr``
    False: none)."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            shape=self._normalized_shape, attr=weight_attr,
            default_initializer=init.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, " \
               f"epsilon={self._epsilon}"
