"""``torch.export`` resolution — twin of
``paddle_tpu/framework/export_compat.py`` (there ``jax.export``).

The program artifacts of the declarative half (``static.Program.save``
and ``save_train``, ``jit.save``, ``inference.Predictor``,
``onnx.export``) are ``torch.export`` programs.  This module is the one
place that resolves what they need from the installed torch —
``export``, ``save``, ``load``, ``move_to_device_pass`` and ``make_fx``
— and gives
one clear error when any of it is missing, instead of an
``AttributeError`` at each call site.

It also keeps the export flag (:func:`exporting`): while one of those
entry points traces a function for ``torch.export``, the converted
control flow lowers onto ``torch.cond`` and ``while_loop``.  (The
kernel entries need no flag: they are ``torch.library`` operators, so a
traced program carries each as one node whose route is decided when it
runs.)"""
from __future__ import annotations

import io
import threading
from contextlib import contextmanager
from types import SimpleNamespace

__all__ = ["torch_export", "exporting", "export_scope", "capturing",
           "capture_scope", "is_placeholder"]

_export_api = None
_STATE = threading.local()


def torch_export():
    """``export``, ``save(program, path)``, ``load(path)``,
    ``move_to_device_pass`` and ``make_fx`` (which traces a train step
    below autograd, for ``save_train``) of the installed torch, as one
    namespace.  Raises ImportError naming what is missing when the torch
    has no usable ``torch.export``."""
    global _export_api
    if _export_api is None:
        import torch

        try:
            import torch.export as ex
            from torch.export.passes import move_to_device_pass
            def save(prog, path):
                # without the example inputs (the weights an export was
                # traced at: they are saved beside it), through a buffer,
                # so the artifact keeps the reference's suffix
                try:
                    prog.example_inputs = None
                except AttributeError:
                    pass
                buf = io.BytesIO()
                ex.save(prog, buf)
                with open(path, "wb") as f:
                    f.write(buf.getvalue())

            def load(path):
                with open(path, "rb") as f:
                    return ex.load(io.BytesIO(f.read()))

            from torch.fx.experimental.proxy_tensor import make_fx

            api = SimpleNamespace(export=ex.export, save=save, load=load,
                                  move_to_device_pass=move_to_device_pass,
                                  make_fx=make_fx)
        except (ImportError, AttributeError) as e:
            raise ImportError(
                "the program artifacts need torch.export with save, load "
                "and passes.move_to_device_pass (torch >= 2.6), but the "
                f"installed torch {torch.__version__} lacks them ({e}) — "
                "static Program save/load, jit.save/load, "
                "inference.Predictor and onnx.export are unavailable"
            ) from e
        _export_api = api
    return _export_api


def exporting() -> bool:
    """Whether a function is being traced for ``torch.export`` by one of
    the port's entry points on this thread."""
    return getattr(_STATE, "depth", 0) > 0


@contextmanager
def export_scope():
    """Mark a ``torch.export`` trace (see :func:`exporting`)."""
    _STATE.depth = getattr(_STATE, "depth", 0) + 1
    try:
        yield
    finally:
        _STATE.depth -= 1


def capturing() -> bool:
    """Whether ``jit.to_static`` is running a function on this thread."""
    return getattr(_STATE, "capture", 0) > 0


@contextmanager
def capture_scope():
    """Mark a ``to_static`` run (see :func:`capturing`)."""
    _STATE.capture = getattr(_STATE, "capture", 0) + 1
    try:
        yield
    finally:
        _STATE.capture -= 1


def is_placeholder(value) -> bool:
    """Whether a torch tensor has no data: a fake tensor (a static
    Program's build-time placeholder, or a value traced by
    ``torch.export``) or a tensor on the meta device.  The kernel
    entries are operators whose fake functions answer one; the attention
    entries hand one to the attention operator."""
    import torch
    from torch._subclasses.fake_tensor import is_fake

    return isinstance(value, torch.Tensor) and (
        value.is_meta or is_fake(value))
