"""Unique names — twin of ``paddle_tpu/utils/unique_name.py``:
``generate(key)`` gives ``key_0``, ``key_1``, ...; ``guard()`` runs a
block with fresh counters and restores the old ones after it;
``switch()`` starts fresh counters."""
from __future__ import annotations

import contextlib
from collections import defaultdict

__all__ = ["generate", "guard", "switch"]

_counters = defaultdict(int)


def generate(key="tmp"):
    _counters[key] += 1
    return f"{key}_{_counters[key] - 1}"


@contextlib.contextmanager
def guard(new_generator=None):
    global _counters
    prev = _counters
    _counters = defaultdict(int)
    try:
        yield
    finally:
        _counters = prev


def switch(new_generator=None):
    global _counters
    _counters = defaultdict(int)
