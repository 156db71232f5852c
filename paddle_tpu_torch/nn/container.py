"""Containers — twin of ``paddle_tpu/nn/container.py:11`` ``Sequential``
(sublayers named "0", "1", … as in paddle)."""
from __future__ import annotations

from collections import OrderedDict

from .layer import Layer

__all__ = ["Sequential"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        elif layers and isinstance(layers[0], (list, tuple)):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x
