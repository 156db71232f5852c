"""auto_cast — twin of ``paddle_tpu/amp/auto_cast.py``: the same op
white and black lists (copied verbatim, so an op name casts the same way
in both packages) and the same ``should_cast`` rule, which
``ops.dispatch.apply`` asks for each op's floating inputs."""
from __future__ import annotations

import threading
from typing import Optional

import torch

from ..framework.dtype import convert_dtype

__all__ = ["white_list", "black_list", "auto_cast", "amp_guard",
           "amp_state", "should_cast"]

# the op lists of paddle_tpu/amp/auto_cast.py:12-30 (reference fp16_lists.py)
white_list = {
    "conv2d", "conv1d", "conv3d", "matmul_v2", "mul", "linear", "einsum",
    "conv2d_transpose", "lstm_scan", "gru_scan", "rnn_tanh_scan",
    "flash_attention", "scaled_dot_product_attention", "mha_weights",
}
black_list = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "bce_loss", "reduce_sum",
    "reduce_mean", "logsumexp", "p_norm",
    # batch_norm and layer_norm are not black-listed: they keep their
    # statistics in f32 inside the op and return the input dtype
}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = None
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state():
    return _state


class auto_cast:
    """``with auto_cast(dtype="bfloat16"):`` — ops of the white list run
    on low-precision inputs, ops of the black list on float32 ones."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        self._enable = enable
        self._white = set(custom_white_list or ())
        self._black = set(custom_black_list or ())
        self._level = level
        self._dtype = convert_dtype(dtype)

    def __enter__(self):
        self._prev = (_state.enabled, _state.dtype, _state.level,
                      _state.custom_white, _state.custom_black)
        _state.enabled = self._enable
        _state.dtype = self._dtype
        _state.level = self._level
        _state.custom_white = self._white
        _state.custom_black = self._black
        return self

    def __exit__(self, *exc):
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = self._prev
        return False


amp_guard = auto_cast

# observation ops see their input verbatim
_passthrough = {"print"}


def should_cast(op_name: str) -> Optional[torch.dtype]:
    """The dtype ``op_name``'s floating inputs are cast to, or None."""
    if not _state.enabled or op_name in _passthrough:
        return None
    wl = (white_list | _state.custom_white) - _state.custom_black
    if _state.level == "O2":
        if op_name in (black_list | _state.custom_black):
            return torch.float32
        return _state.dtype
    if op_name in wl:
        return _state.dtype
    if op_name in (black_list | _state.custom_black):
        return torch.float32
    return None
