"""Framework flags — twin of ``paddle_tpu/framework/flags.py``: flags are
declared with defaults (``define_flag``), overridable from the
environment (``FLAGS_<name>``) and from code (``set_flags`` /
``get_flags``), under the JAX package's names.

Four flags are honoured: ``check_nan_inf`` (``ops.dispatch.apply``
sweeps each op's outputs), ``enable_unused_var_check`` (a warning in
``Optimizer.step``), ``cudnn_deterministic`` (torch's
``cudnn.deterministic``) and ``tpu_matmul_precision`` (torch's f32
matmul and convolution precision: ``"default"`` leaves torch's defaults,
``"high"`` allows TF32 in both, ``"highest"`` forbids it in both).  The
others keep their names and defaults; setting one to another value
raises ``InvalidArgumentError``, since the port does not act on it."""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

from .errors import InvalidArgumentError

__all__ = ["define_flag", "set_flags", "get_flags", "flag_value"]


class _Flag:
    __slots__ = ("name", "default", "value", "type", "help", "on_change",
                 "honoured")

    def __init__(self, name, default, help="", on_change=None,
                 honoured=True):
        self.name = name
        self.default = default
        self.value = default
        self.type = type(default)
        self.help = help
        self.on_change: Optional[Callable[[Any], None]] = on_change
        self.honoured = honoured


_REGISTRY: Dict[str, _Flag] = {}


def define_flag(name: str, default, help: str = "", on_change=None,
                honoured: bool = True):
    """Declare a flag; ``honoured=False`` accepts only its default."""
    flag = _Flag(name, default, help, on_change, honoured)
    _REGISTRY[name] = flag
    env = os.environ.get("FLAGS_" + name)
    if env is not None:
        _assign(flag, _parse(env, flag.type))
    return flag


def _assign(flag: _Flag, value):
    if not flag.honoured and value != flag.default:
        raise InvalidArgumentError(
            f"FLAGS_{flag.name}={value!r}: paddle_tpu_torch does not act "
            f"on this flag and accepts only its default {flag.default!r}")
    if flag.on_change is not None:
        flag.on_change(value)
    flag.value = value


def _parse(text: str, ty):
    if ty is bool:
        return text.strip().lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(text)
    if ty is float:
        return float(text)
    return text


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _REGISTRY:
        raise KeyError(f"unknown flag {name!r}")
    return key


def set_flags(flags: Dict[str, Any]):
    for name, value in flags.items():
        flag = _REGISTRY[_key(name)]
        _assign(flag, _parse(value, flag.type) if isinstance(value, str)
                else flag.type(value))


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    return {name: _REGISTRY[_key(name)].value for name in flags}


def flag_value(name: str):
    return _REGISTRY[name].value


def _cudnn_deterministic(value):
    import torch

    torch.backends.cudnn.deterministic = bool(value)


def _matmul_precision(value):
    if value not in ("default", "high", "highest"):
        raise InvalidArgumentError(
            f"FLAGS_tpu_matmul_precision={value!r}: expected 'default', "
            "'high' or 'highest'")
    import torch

    torch.set_float32_matmul_precision(
        "high" if value == "high" else "highest")
    torch.backends.cudnn.allow_tf32 = value != "highest"


define_flag("check_nan_inf", False,
            "scan op outputs for NaN/Inf after each eager op")
define_flag("enable_unused_var_check", False,
            "warn when optimizer.step() sees trainable parameters with no "
            "gradient")
define_flag("cudnn_deterministic", False,
            "torch.backends.cudnn.deterministic",
            on_change=_cudnn_deterministic)
define_flag("tpu_matmul_precision", "default",
            "f32 matmul and convolution precision: default (torch's "
            "defaults), high (TF32), highest (no TF32)",
            on_change=_matmul_precision)
for _name, _default in (
        ("benchmark", False), ("eager_delete_tensor_gb", 0.0),
        ("allocator_strategy", "auto_growth"),
        ("fraction_of_gpu_memory_to_use", 0.92), ("seed", 0),
        ("max_inplace_grad_add", 0), ("call_stack_level", 1),
        ("use_mkldnn", False), ("sync_nccl_allreduce", False),
        ("fuse_parameter_memory_size", -1.0), ("init_allocated_mem", False),
        ("free_idle_chunk", False), ("use_pinned_memory", True),
        ("reader_queue_speed_test_mode", False),
        ("tpu_donate_buffers", True)):
    define_flag(_name, _default, "not acted on: only the default",
                honoured=False)
