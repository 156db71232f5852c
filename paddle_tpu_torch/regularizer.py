"""Weight-decay regularizers — twin of ``paddle_tpu/regularizer.py``.

The optimizer applies them to each gradient before its rule, on the
device: ``L2Decay`` adds ``coeff · p``, ``L1Decay`` adds
``coeff · sign(p)``."""
from __future__ import annotations

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff


class L2Decay(WeightDecayRegularizer):
    """grad += coeff * param (applied inside the optimizer update)."""


class L1Decay(WeightDecayRegularizer):
    """grad += coeff * sign(param)."""
