"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its layout module for module (``paddle_tpu_torch/text/generation.py`` is
the twin of ``paddle_tpu/text/generation.py``) and imports only ``torch``
and numpy.  Every Pallas kernel on a ported path has a hand-written
CUDA twin under ``ops/csrc/``; plain tensor code is PyTorch.

The dygraph core is the paddle API over torch: ``Tensor``,
``to_tensor``, ``seed``, ``set_device``/``get_device`` here, ``nn.Layer``
and its layers, ``optimizer`` and ``utils.register_op``.  The training
front door is here under the JAX package's names: ``Model`` and
``summary`` (``hapi``), ``callbacks``, ``metric``, ``io`` (``DataLoader``
and the datasets) and ``regularizer``.

Device policy: entry points take an explicit ``device``.  The default
(``None``) means the CUDA card; without one it raises instead of falling
back to the CPU.  Tests pass ``device="cpu"``, where every kernel wrapper
runs its plain PyTorch version.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__", "Tensor", "Parameter",
           "to_tensor", "seed", "set_device", "get_device", "Model",
           "summary", "callbacks", "metric", "io", "regularizer"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    A CUDA device without a card raises — the port never silently runs a
    GPU entry point on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False — pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        # pin the index, so "cuda" and the tensors' "cuda:0" compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


from .framework.place import get_device, set_device  # noqa: E402
from .framework.random import seed  # noqa: E402
from .tensor import Parameter, Tensor, to_tensor  # noqa: E402
from . import io, metric, regularizer  # noqa: E402,F401
from .hapi import Model, callbacks, summary  # noqa: E402,F401
