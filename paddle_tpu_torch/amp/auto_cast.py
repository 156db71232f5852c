"""auto_cast and decorate — twin of ``paddle_tpu/amp/auto_cast.py``: the
same op white and black lists (copied verbatim, so an op name casts the
same way in both packages) and the same ``should_cast`` rule.
``cast_inputs`` applies it to an op's floating inputs:
``ops.dispatch.apply``, the attention ops and ``GPTModel``'s layers all
cast through it.  ``decorate(level="O2")`` casts the models' parameters
and buffers to the low dtype, as the JAX package's does: there are no
master weights (an optimizer's accumulators are ``zeros_like`` the
parameter, its update computed in f32 and cast back)."""
from __future__ import annotations

import threading
from typing import Optional

import torch

from ..framework.dtype import convert_dtype

__all__ = ["white_list", "black_list", "auto_cast", "amp_guard",
           "amp_state", "should_cast", "cast_inputs", "decorate"]

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


def cast_inputs(op_name: str, *tensors):
    """``tensors`` with the floating torch tensors among them cast to
    ``should_cast(op_name)``'s dtype; the rest, and all of them when AMP
    leaves the op alone, pass through unchanged."""
    dtype = should_cast(op_name)
    if dtype is None:
        return tensors
    return tuple(t.to(dtype) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() else t for t in tensors)


def _repoint(optimizer):
    """Point ``optimizer`` at its parameters' current tensors.  A port
    ``Layer.to(dtype=)`` gives each parameter a new torch tensor, which an
    optimizer built before it would not see (the JAX package rewrites
    ``_value`` of the same objects and needs no such step); accumulators
    made already move to the new tensor's key, as they are."""
    objs = getattr(optimizer, "_param_objs", None)
    if objs is None:
        return
    old = optimizer._parameters or []
    new = [p._value if hasattr(p, "_value") else p for p in objs]
    for store in optimizer._accumulators.values():
        for o, n in zip(old, new):
            if o is not n and id(o) in store:
                store[id(n)] = store.pop(id(o))
    optimizer._parameters = new


def decorate(models=None, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, **kw):
    """Level O2: cast every model's floating parameters and buffers to
    ``dtype`` (a port ``Layer`` or a ``torch.nn.Module``) and re-point
    each optimizer given at the cast parameters; O1 changes nothing.
    Returns ``models``, or ``(models, optimizers)`` when optimizers are
    given — the JAX package's return."""
    if level == "O2" and models is not None:
        items = models if isinstance(models, (list, tuple)) else [models]
        for m in items:
            m.to(dtype=convert_dtype(dtype))
        opts = (optimizers if isinstance(optimizers, (list, tuple))
                else [optimizers] if optimizers is not None else [])
        for opt in opts:
            _repoint(opt)
    if optimizers is None:
        return models
    return models, optimizers
