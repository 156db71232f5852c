"""Automatic mixed precision — twin of ``paddle_tpu/amp``: ``auto_cast``
and its op lists, ``decorate`` (level O2) and the fp16 loss scalers
``AmpScaler`` / ``GradScaler``."""
from .auto_cast import (amp_guard, auto_cast, black_list,  # noqa: F401
                        decorate, should_cast, white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "white_list", "black_list",
           "should_cast", "decorate", "AmpScaler", "GradScaler"]
