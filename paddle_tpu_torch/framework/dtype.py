"""Paddle dtypes as torch dtypes — twin of ``paddle_tpu/framework/dtype.py``.

The dtype objects are torch dtypes (``float32`` is ``torch.float32``,
``bool_`` is ``torch.bool``); ``convert_dtype`` takes a paddle name
(``"bfloat16"``), a numpy dtype or a torch dtype.  The default dtype of
creation and random ops is float32 until ``set_default_dtype`` names
another floating dtype, as in the JAX package (``:80-92``)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "dtype_name", "is_floating", "is_integer",
           "get_default_dtype", "set_default_dtype"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_BY_NAME = {
    "float32": torch.float32, "float": torch.float32, "fp32": torch.float32,
    "float64": torch.float64, "double": torch.float64,
    "float16": torch.float16, "half": torch.float16, "fp16": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_INTEGER = {uint8, int8, int16, int32, int64}
_DEFAULT = {"dtype": torch.float32}


def convert_dtype(dtype):
    """A torch dtype from a paddle name (``"bfloat16"``), a numpy dtype or
    type, or a torch dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower().replace("paddle.", "").replace("torch.", "")
        if key in _BY_NAME:
            return _BY_NAME[key]
        raise ValueError(f"unknown dtype {dtype!r}")
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"cannot interpret dtype: {dtype!r}") from None
    if name not in _BY_NAME:
        raise ValueError(f"unsupported dtype {name!r}")
    return _BY_NAME[name]


def dtype_name(dtype) -> str:
    """The paddle name of a dtype: ``"float32"``, ``"bool"``."""
    return str(convert_dtype(dtype)).replace("torch.", "")


def is_floating(dtype) -> bool:
    """Floating or complex (the dtypes autograd differentiates)."""
    d = convert_dtype(dtype)
    return d.is_floating_point or d.is_complex


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in _INTEGER


def get_default_dtype() -> torch.dtype:
    return _DEFAULT["dtype"]


def set_default_dtype(dtype):
    d = convert_dtype(dtype)
    if d not in (float16, bfloat16, float32, float64):
        raise ValueError(
            "default dtype must be a floating dtype, got %s" % dtype_name(d))
    _DEFAULT["dtype"] = d
