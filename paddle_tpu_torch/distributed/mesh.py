"""The single-controller device mesh — the port's copy of what the serving
mesh needs from ``paddle_tpu/distributed/mesh.py``.

The JAX package runs a mesh replica as ONE program over a named mesh of
``jax.devices()``: one process, every shard's weights and pools on its
own device, the collectives inside the program.  The port keeps that
design.  A mesh is a grid of device *slots*; each shard's tensors live on
its slot, one process drives every shard in turn, and the collectives
(:func:`pmax`, :func:`psum`, the tiled :func:`all_gather`) are tensor
operations over the shards' outputs that leave their result on every
shard's slot.  Several slots may name one device: on one card, four
slots share ``cuda:0``; on a machine with several cards the same code
spreads them over the cards.

:func:`force_device_count` is the twin of XLA's
``--xla_force_host_platform_device_count``: an explicit call that makes
:func:`devices` return n slots spread round-robin over the real devices.
Nothing calls it behind the caller's back.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["devices", "force_device_count", "Mesh", "init_mesh",
           "get_mesh", "pmax", "psum", "all_gather"]

_FORCED: Optional[int] = None
_GLOBAL_MESH: Optional["Mesh"] = None


def _real_devices(device_type: Optional[str]) -> List[torch.device]:
    """Every device of ``device_type``: None means the CUDA cards, as for
    every entry point of the port (``paddle_tpu_torch.resolve_device``),
    and raises without one; the CPU only when the caller names it."""
    if device_type is None or device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the mesh's devices are the CUDA cards, but "
                "torch.cuda.is_available() is False — pass "
                "device_type='cpu' to build a mesh on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {device_type!r} (cuda or "
                     "cpu)")


def _device_slots(device_type: Optional[str] = None) -> List[torch.device]:
    """The mesh's device slots: every CUDA card (``device_type`` None or
    ``"cuda"``; raises without one), or the CPU (``"cpu"``) — or, after
    :func:`force_device_count`, that many slots round-robin over them."""
    real = _real_devices(device_type)
    if _FORCED is None or not real:
        return real
    return [real[i % len(real)] for i in range(_FORCED)]


devices = _device_slots


def force_device_count(n: Optional[int]) -> Optional[int]:
    """Make :func:`devices` return ``n`` slots (None restores the real
    count); returns the previous setting, so a caller can put it back."""
    global _FORCED
    if n is not None and int(n) < 1:
        raise ValueError(f"device count must be >= 1, got {n}")
    prev, _FORCED = _FORCED, None if n is None else int(n)
    return prev


class Mesh:
    """Named axes over a grid of device slots: ``slot(**coords)`` is the
    device of one shard (missing axes at 0), ``shape[name]`` an axis'
    size, ``slots`` the flat list in row-major order of ``axis_names``."""

    def __init__(self, axes: Dict[str, int], slots: Sequence[torch.device]):
        self.axis_names = tuple(axes)
        self.shape = {name: int(n) for name, n in axes.items()}
        size = 1
        for n in self.shape.values():
            size *= n
        if len(slots) != size:
            raise ValueError(f"mesh {axes} needs {size} slots, got "
                             f"{len(slots)}")
        self.slots = list(slots)

    def slot(self, **coords) -> torch.device:
        idx = 0
        for name in self.axis_names:
            idx = idx * self.shape[name] + int(coords.get(name, 0))
        return self.slots[idx]


def init_mesh(axes: Dict[str, int], devices=None,
              device_type: Optional[str] = None) -> Mesh:
    """Create and install the global mesh, e.g. ``init_mesh({"tp": 2,
    "sp": 2})``, over the first ``prod(axes)`` of ``devices`` (default
    the slots of :func:`devices` for ``device_type``).  Raises
    ``ValueError`` when the mesh needs more slots than there are
    devices."""
    global _GLOBAL_MESH
    devs = list(devices if devices is not None
                else _device_slots(device_type))
    total = 1
    for n in axes.values():
        total *= int(n)
    if total > len(devs):
        raise ValueError(f"mesh {axes} needs {total} devices, have "
                         f"{len(devs)}")
    _GLOBAL_MESH = Mesh(axes, devs[:total])
    return _GLOBAL_MESH


def get_mesh() -> Mesh:
    """The installed mesh, or a one-axis ``dp`` mesh over every slot."""
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None:
        devs = _device_slots()
        _GLOBAL_MESH = Mesh({"dp": len(devs)}, devs)
    return _GLOBAL_MESH


def _everywhere(result: torch.Tensor, xs: Sequence[torch.Tensor]):
    """``result`` on every shard's slot (one copy per distinct device)."""
    on = {}
    out = []
    for x in xs:
        t = on.get(x.device)
        if t is None:
            t = on[x.device] = result.to(x.device)
        out.append(t)
    return out


def pmax(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise max over the shards' tensors, on every shard's slot."""
    acc = xs[0]
    for x in xs[1:]:
        acc = torch.maximum(acc, x.to(acc.device))
    return _everywhere(acc, xs)


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum over the shards' tensors in shard order, on every shard's
    slot."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(acc.device)
    return _everywhere(acc, xs)


def all_gather(xs: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """The tiled all-gather: the shards' tensors concatenated along
    ``dim`` in shard order, on every shard's slot."""
    dev = xs[0].device
    full = torch.cat([x.to(dev) for x in xs], dim=dim)
    return _everywhere(full, xs)
