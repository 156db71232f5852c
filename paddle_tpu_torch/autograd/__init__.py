"""Grad-mode switches — twins of ``paddle_tpu/autograd``'s ``no_grad``,
``enable_grad``, ``set_grad_enabled`` and ``is_grad_enabled``, over torch
autograd (the JAX tape is not re-implemented: torch records the graph,
and ``Tensor.backward`` runs ``torch.autograd.backward``).  Each works as
a context manager and ``no_grad``/``enable_grad`` as decorators too."""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()
