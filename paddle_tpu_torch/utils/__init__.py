"""paddle_tpu_torch.utils — twin of ``paddle_tpu.utils``: the custom-op
API (``register_op``), ``unique_name``, the profiler helpers,
``run_check`` (a product on the card), ``try_import``, ``deprecated``,
``require_version`` and ``OpLastCheckpointChecker``."""
from . import profiler, unique_name  # noqa: F401
from .custom_op import (CustomOp, get_op, register_op,  # noqa: F401
                        registered_ops, unregister_op)
from .profiler import profiler as get_profiler  # noqa: F401

__all__ = ["CustomOp", "register_op", "get_op", "registered_ops",
           "unregister_op", "unique_name", "profiler", "get_profiler",
           "ProfilerOptions", "deprecated", "run_check", "try_import",
           "require_version", "OpLastCheckpointChecker"]


def deprecated(update_to="", since="", reason=""):
    """A decorator that leaves the function as it is."""
    def wrapper(fn):
        return fn

    return wrapper


def run_check(device=None):
    """Check that the port computes on ``device`` (the default place):
    a 128 x 128 product of ones, every entry 128.  Prints the device and
    returns True; raises if the product is wrong."""
    import torch

    from ..framework.place import to_device

    dev = to_device(device)
    x = torch.ones((128, 128), dtype=torch.float32, device=dev)
    y = x @ x
    if not bool(torch.all(y == 128.0)):
        raise RuntimeError(f"paddle_tpu_torch: a product on {dev} is wrong")
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"paddle_tpu_torch works on {dev} ({n} device(s) visible).")
    return True


def try_import(module_name):
    """The module, or None where it cannot be imported."""
    import importlib

    try:
        return importlib.import_module(module_name)
    except ImportError:
        return None


class ProfilerOptions:
    """The knobs ``get_profiler`` reads."""

    def __init__(self, options=None):
        self.options = {
            "state": "All", "sorted_key": "default", "tracer_level": "Default",
            "batch_range": [0, 100], "output_thread_detail": False,
            "profile_path": "none", "timeline_path": "none",
            "op_summary_path": "none",
        }
        if options is not None:
            self.options.update(options)

    def __getitem__(self, name):
        return self.options[name]


def require_version(min_version, max_version=None):
    """Raise unless ``min_version <= __version__ <= max_version``."""
    from .. import __version__

    def parse(v):
        return [int(x) for x in str(v).split(".") if x.isdigit()]

    cur = parse(__version__)
    if parse(min_version) > cur:
        raise Exception(
            f"installed version {__version__} < required {min_version}")
    if max_version is not None and parse(max_version) < cur:
        raise Exception(
            f"installed version {__version__} > allowed {max_version}")


class OpLastCheckpointChecker:
    """Queries the op version checkpoints (``framework/op_version.py``).
    ``get_op_attrs`` reads a ``get_op_version`` the module does not
    define, so it returns ``[]`` for every op, as the JAX package's
    does."""

    def __init__(self):
        from ..framework import op_version

        self._registry = op_version

    def get_op_attrs(self, op_name):
        info = (self._registry.get_op_version(op_name)
                if hasattr(self._registry, "get_op_version") else None)
        return info or []
