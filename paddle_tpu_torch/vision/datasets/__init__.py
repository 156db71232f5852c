from .mnist import MNIST  # noqa: F401

__all__ = ["MNIST"]
