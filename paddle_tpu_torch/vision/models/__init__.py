from .lenet import LeNet  # noqa: F401

__all__ = ["LeNet"]
