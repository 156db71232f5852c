"""Common layers — twins of ``paddle_tpu/nn/common_layers.py``'s
``Linear`` (``:14``), ``Identity`` (``:37``), ``Embedding`` (``:45``),
``Flatten`` (``:68``) and ``Dropout`` (``:79``)."""
from __future__ import annotations

import torch

from . import functional as F
from . import initializer as init
from .layer import Layer

__all__ = ["Linear", "Identity", "Embedding", "Flatten", "Dropout"]


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


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Embedding(Layer):
    """A ``[num_embeddings, embedding_dim]`` table (XavierNormal); the row
    of ``padding_idx`` starts at zero and reads as zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (
            None if padding_idx is None
            else padding_idx if padding_idx >= 0
            else num_embeddings + padding_idx)
        self._sparse = sparse
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=init.XavierNormal())
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight._value[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)
