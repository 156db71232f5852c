"""``seed`` — twin of ``paddle_tpu/framework/random.py:78``.

Each device has an explicit ``torch.Generator``; ``seed(value)`` seeds
them all and the initializers draw from them.  Nothing touches torch's
global generator (no ``torch.manual_seed``).  The draws are not the JAX
package's threefry draws: tests copy weights across instead."""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["seed", "generator"]

_STATE: Dict[str, object] = {"seed": None}
_GENERATORS: Dict[str, torch.Generator] = {}


def generator(device="cpu") -> torch.Generator:
    """The generator of ``device``, made at first use and seeded with the
    last ``seed`` value (or fresh entropy before any ``seed`` call)."""
    dev = torch.device(device)
    key = str(dev)
    gen = _GENERATORS.get(key)
    if gen is None:
        gen = torch.Generator(device=dev)
        if _STATE["seed"] is None:
            gen.seed()
        else:
            gen.manual_seed(_STATE["seed"])
        _GENERATORS[key] = gen
    return gen


def seed(value: int) -> torch.Generator:
    """Seed every device's generator; returns the CPU one."""
    _STATE["seed"] = int(value)
    for gen in _GENERATORS.values():
        gen.manual_seed(int(value))
    return generator("cpu")
