"""Framework flags — the subset of ``paddle_tpu/framework/flags.py`` the
dygraph core reads: ``check_nan_inf`` (scan each op's outputs for NaN or
Inf in ``ops.dispatch.apply``)."""
from __future__ import annotations

__all__ = ["set_flags", "get_flags", "flag_value"]

_REGISTRY = {"check_nan_inf": False}


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _REGISTRY:
        raise KeyError(f"unknown flag {name!r}")
    return key


def set_flags(flags: dict):
    for name, value in flags.items():
        key = _key(name)
        _REGISTRY[key] = type(_REGISTRY[key])(value)


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    return {name: _REGISTRY[_key(name)] for name in flags}


def flag_value(name: str):
    return _REGISTRY[name]
