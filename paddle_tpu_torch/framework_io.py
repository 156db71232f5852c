"""paddle_tpu_torch.save / load and the atomic writer — the twin of
``paddle_tpu/framework_io.py``.

The on-disk payload is the JAX package's: a pickled nested dict whose
tensors are numpy arrays (``{"__tensor__": True, "data": ndarray, ...}``),
so a file or a ``CheckpointStore`` slot written by either package loads
in the other.  Tensors are copied to the host when they are serialised.
``load`` puts them on the default place (the card unless
``set_device`` named the CPU), as the reference's ``Tensor(data)`` lands
on its default device, or returns numpy arrays with ``return_numpy``;
``deserialize_bytes`` (``CheckpointStore``'s reader) gives CPU tensors.

Crash consistency: ``save`` commits through ``atomic_write_bytes`` —
write to a temp file in the same directory, flush + fsync, then
``os.replace`` onto the destination.  A process killed at ANY point
mid-save leaves either the previous complete file or the previous file
plus a stray ``*.tmp.*`` dropping; it can never tear the destination.
The deterministic ``ckpt.write`` chaos sites (``temp`` mid-temp-write,
``rename`` between the fsync and the rename — see
``paddle_tpu_torch.testing.chaos``) let tests kill the writer at each
injection point.
"""
from __future__ import annotations

import itertools
import os
import pickle
from typing import Any

import numpy as np
import torch

from .tensor import Parameter, Tensor

__all__ = ["serialize_bytes", "deserialize_bytes", "atomic_write_bytes",
           "save", "load"]

_PROTOCOL = 4
_TMP_SEQ = itertools.count()


def _to_serializable(obj):
    if isinstance(obj, Tensor):
        return {"__tensor__": True,
                "data": obj._value.detach().cpu().numpy(),
                "stop_gradient": obj.stop_gradient,
                "is_param": isinstance(obj, Parameter), "name": obj.name}
    if isinstance(obj, torch.Tensor):
        # a raw torch tensor travels as its numpy array, which both
        # packages read back as-is
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_to_serializable(v) for v in obj)
    return obj


def _from_serializable(obj, return_numpy=False, device=None):
    """The payload tree with its tensors rebuilt on ``device`` (None:
    the CPU)."""
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return obj["data"]
            cls = Parameter if obj.get("is_param") else Tensor
            v = torch.from_numpy(np.array(obj["data"]))
            if device is not None:
                v = v.to(device)
            t = cls(v)
            t.stop_gradient = obj.get("stop_gradient", True)
            t.name = obj.get("name")
            return t
        return {k: _from_serializable(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_serializable(v, return_numpy, device)
                         for v in obj)
    return obj


def serialize_bytes(obj: Any, protocol: int = _PROTOCOL) -> bytes:
    """Pickle ``obj`` with tensors converted to numpy (the on-disk payload
    format shared by ``save`` and ``io.checkpoint.CheckpointStore``)."""
    return pickle.dumps(_to_serializable(obj), protocol=protocol)


def deserialize_bytes(data: bytes, return_numpy: bool = False):
    return _from_serializable(pickle.loads(data), return_numpy=return_numpy)


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True,
                       chaos: bool = True) -> None:
    """Crash-consistent file commit: temp in the same directory + fsync +
    ``os.replace``.  Readers of ``path`` see the old complete content or
    the new complete content, never a torn mix.

    ``chaos=True`` evaluates the deterministic ``ckpt.write`` injection
    points (key ``temp`` after a partial temp write, key ``rename``
    after the fsync but before the rename) — a chaos ``raise`` there
    models a kill at that instant: no further bytes are written, the
    stray temp file stays behind exactly as a real crash would leave it.
    Writers inside failure handling (the flight recorder's postmortem
    bundle) pass ``chaos=False``.
    """
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if chaos:
        from .testing.chaos import chaos_site
    else:
        def chaos_site(site, key=None):
            return None
    tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_SEQ)}"
    with open(tmp, "wb") as f:
        mid = len(data) // 2
        f.write(data[:mid])
        # injection point 1: the temp file holds only a PARTIAL payload
        chaos_site("ckpt.write", key="temp")
        f.write(data[mid:])
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    # injection point 2: temp complete + durable, destination untouched
    chaos_site("ckpt.write", key="rename")
    os.replace(tmp, path)
    if fsync and d:
        # durably record the directory entry (the rename itself)
        try:
            dfd = os.open(d, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


def save(obj: Any, path: str, protocol: int = _PROTOCOL, **configs):
    atomic_write_bytes(path, serialize_bytes(obj, protocol))


def load(path: str, return_numpy: bool = False, **configs):
    """What ``save`` wrote, its tensors on the default place (numpy
    arrays with ``return_numpy``)."""
    from .framework.place import to_device

    with open(path, "rb") as f:
        raw = pickle.load(f)
    dev = None if return_numpy else to_device(None)
    return _from_serializable(raw, return_numpy=return_numpy, device=dev)
