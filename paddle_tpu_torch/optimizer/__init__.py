"""Optimizers — twin of ``paddle_tpu/optimizer`` (SGD, Adam, AdamW)."""
from .optimizer import SGD, Adam, AdamW, Optimizer  # noqa: F401

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]
