"""Paddle dtype names onto torch dtypes — the subset of
``paddle_tpu/framework/dtype.py`` the dygraph core needs."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "is_floating"]

_BY_NAME = {
    "float32": torch.float32, "float": torch.float32, "fp32": torch.float32,
    "float64": torch.float64, "double": torch.float64,
    "float16": torch.float16, "half": torch.float16, "fp16": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


def convert_dtype(dtype) -> torch.dtype:
    """A torch dtype from a paddle name (``"bfloat16"``), a numpy dtype or
    a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower().replace("paddle.", "").replace("torch.", "")
        if key in _BY_NAME:
            return _BY_NAME[key]
        raise ValueError(f"unknown dtype {dtype!r}")
    return _BY_NAME[np.dtype(dtype).name]


def is_floating(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex
