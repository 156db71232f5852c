"""Places and the default place of new tensors and parameters — twin of
``paddle_tpu/framework/place.py`` (``Place`` and its kinds,
``set_device`` / ``get_device``, ``is_compiled_with_*``).

The default is the CUDA card.  ``set_device("cpu")`` (or a ``CPUPlace``)
is how a caller asks for the CPU; ``"gpu"``/``"cuda"`` without a card
raises, like ``paddle_tpu_torch.resolve_device``: nothing falls back to
the CPU.  A ``Place`` names a torch device (``CUDAPlace(1)`` is
``cuda:1``, ``CUDAPinnedPlace`` the CPU); ``TPUPlace`` and ``XPUPlace``
exist for the API, and using one as a place raises
``InvalidArgumentError`` (the JAX package maps them to its accelerator,
which this port does not have)."""
from __future__ import annotations

import torch

from .errors import InvalidArgumentError

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "XPUPlace", "set_device", "get_device", "default_device",
           "default_place", "to_device", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "is_compiled_with_xpu"]

_DEFAULT = {"device": None}       # None: the card, resolved at first use


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    @property
    def torch_device(self) -> torch.device:
        raise InvalidArgumentError(
            f"{self!r} names no device of this port (cpu or gpu)")

    def __eq__(self, other):
        return (type(self) is type(other)
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((type(self).__name__, self._device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self._device_id})"


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self):
        super().__init__(0)

    @property
    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """The CUDA card ``device_id``."""

    device_type = "gpu"

    @property
    def torch_device(self) -> torch.device:
        from .. import resolve_device

        return resolve_device(f"cuda:{self._device_id}")


class CUDAPinnedPlace(Place):
    """Page-locked host memory: the CPU as a device."""

    device_type = "cpu"

    def __init__(self):
        super().__init__(0)

    @property
    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class TPUPlace(Place):
    device_type = "tpu"


class XPUPlace(Place):
    device_type = "xpu"


def to_device(device) -> torch.device:
    """A torch device from a ``Place``, a paddle place string (``"cpu"``,
    ``"gpu"``, ``"gpu:1"``, ``"cuda:0"``) or a torch device; ``None`` is
    the default place."""
    if device is None:
        return default_device()
    if isinstance(device, Place):
        return device.torch_device
    from .. import resolve_device

    if isinstance(device, str):
        name, _, idx = device.lower().partition(":")
        if name in ("tpu", "xpu"):
            raise InvalidArgumentError(
                f"unknown device {device!r}: it names no device of this "
                "port (cpu or gpu)")
        if name == "gpu":
            name = "cuda"
        if name not in ("cpu", "cuda"):
            raise ValueError(f"unknown device {device!r} (cpu, gpu or cuda)")
        device = name if name == "cpu" or not idx else f"cuda:{int(idx)}"
    return resolve_device(device)


def set_device(device) -> torch.device:
    """Make ``device`` (a place string or a ``Place``) the place of new
    tensors and parameters."""
    dev = to_device(device)
    _DEFAULT["device"] = dev
    return dev


def default_device() -> torch.device:
    dev = _DEFAULT["device"]
    return dev if dev is not None else to_device("cuda")


def default_place() -> Place:
    """The default place as a ``Place``."""
    dev = default_device()
    return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index)


def get_device() -> str:
    """``"cpu"`` or ``"gpu:<index>"``, as paddle spells it."""
    dev = default_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def is_compiled_with_cuda() -> bool:
    """Whether this torch build has CUDA (the card may still be absent)."""
    return torch.version.cuda is not None


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False
