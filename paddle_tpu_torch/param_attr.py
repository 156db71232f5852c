"""ParamAttr — twin of ``paddle_tpu/param_attr.py``: the settings a
layer gives a parameter it creates (``nn.Layer.create_parameter``):
its name, initializer, ``trainable``, the learning-rate scale and the
regularizer the optimizer applies to it, and whether the gradient clip
sees it (``need_clip``)."""
from __future__ import annotations

from typing import Optional

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, do_model_average: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None, a ParamAttr, a name or a bare initializer as a
        ParamAttr."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if callable(attr):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot interpret ParamAttr from {attr!r}")
