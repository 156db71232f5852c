"""Automatic mixed precision — twin of ``paddle_tpu/amp`` (``auto_cast``
and its op lists)."""
from .auto_cast import (amp_guard, auto_cast, black_list,  # noqa: F401
                        should_cast, white_list)

__all__ = ["auto_cast", "amp_guard", "white_list", "black_list",
           "should_cast"]
