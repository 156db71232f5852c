"""The default place of new tensors and parameters — twin of
``paddle_tpu/framework/place.py`` (``set_device`` / ``get_device``).

The default is the CUDA card.  ``set_device("cpu")`` is how a caller asks
for the CPU; ``"gpu"``/``"cuda"`` without a card raises, like
``paddle_tpu_torch.resolve_device``: nothing falls back to the CPU."""
from __future__ import annotations

import torch

__all__ = ["set_device", "get_device", "default_device", "to_device"]

_DEFAULT = {"device": None}       # None: the card, resolved at first use


def to_device(device) -> torch.device:
    """A torch device from a paddle place string (``"cpu"``, ``"gpu"``,
    ``"gpu:1"``, ``"cuda:0"``) or a torch device; ``None`` is the default
    place."""
    if device is None:
        return default_device()
    from .. import resolve_device

    if isinstance(device, str):
        name, _, idx = device.lower().partition(":")
        if name == "gpu":
            name = "cuda"
        if name not in ("cpu", "cuda"):
            raise ValueError(f"unknown device {device!r} (cpu, gpu or cuda)")
        device = name if name == "cpu" or not idx else f"cuda:{int(idx)}"
    return resolve_device(device)


def set_device(device) -> torch.device:
    """Make ``device`` the place of new tensors and parameters."""
    dev = to_device(device)
    _DEFAULT["device"] = dev
    return dev


def default_device() -> torch.device:
    dev = _DEFAULT["device"]
    return dev if dev is not None else to_device("cuda")


def get_device() -> str:
    """``"cpu"`` or ``"gpu:<index>"``, as paddle spells it."""
    dev = default_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"
