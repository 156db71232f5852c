"""``seed`` — twin of ``paddle_tpu/framework/random.py:78``.

Each device has an explicit ``torch.Generator``; ``seed(value)`` seeds
them all and the initializers draw from them.  Nothing touches torch's
global generator (no ``torch.manual_seed``).  The draws are not the JAX
package's threefry draws: tests copy weights across instead.

As in the JAX package, ``seed`` also seeds numpy's global stream (the
samplers' shuffles) and ``py_random``, the stdlib generator for host-side
augmentation; ``get_rng_state`` / ``set_rng_state`` carry the device
generators through a training checkpoint."""
from __future__ import annotations

import random as _stdlib_random
import threading
from contextlib import contextmanager
from typing import Dict

import numpy as np
import torch

__all__ = ["seed", "generator", "py_random", "get_rng_state",
           "set_rng_state", "slot_generators"]

py_random = _stdlib_random.Random()

_STATE: Dict[str, object] = {"seed": None}
_GENERATORS: Dict[str, torch.Generator] = {}
# a shard_map body's own generators ({device: generator}), per thread
_SLOT = threading.local()


@contextmanager
def slot_generators(gens: Dict[str, torch.Generator]):
    """Inside, :func:`generator` of a device in ``gens`` (keyed by
    ``str(device)``) returns that generator on this thread: each slot of
    a mesh draws from its own stream (``distributed/mesh.py``)."""
    prev = getattr(_SLOT, "gens", None)
    _SLOT.gens = gens
    try:
        yield
    finally:
        _SLOT.gens = prev


def generator(device="cpu") -> torch.Generator:
    """The generator of ``device``, made at first use and seeded with the
    last ``seed`` value (or fresh entropy before any ``seed`` call).
    ``"cuda"`` names the current card, so it shares ``"cuda:N"``'s
    generator; a CUDA graph registers it (``profiler.jit_cost``), so
    every replay draws anew."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    own = getattr(_SLOT, "gens", None)
    if own is not None and key in own:
        return own[key]
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
    np.random.seed(int(value) % (2 ** 32))
    py_random.seed(int(value))
    return generator("cpu")


def get_rng_state() -> Dict[str, np.ndarray]:
    """``{device: generator state}`` of every device generator made so
    far (uint8 arrays)."""
    return {key: gen.get_state().numpy().copy()
            for key, gen in _GENERATORS.items()}


def set_rng_state(state: Dict[str, np.ndarray]):
    """Restore what :func:`get_rng_state` returned (making a device's
    generator first where needed)."""
    for key, arr in state.items():
        generator(key).set_state(torch.as_tensor(np.asarray(arr),
                                                 dtype=torch.uint8))
