"""The eager op dispatcher — twin of ``paddle_tpu/ops/dispatch.py:139``
``apply``.

``apply(name, fn, *args, **attrs)`` unwraps ``Tensor`` arguments, casts
their floating values as AMP says for ``name`` (the same op names and
lists as paddle_tpu, so "linear" and "conv2d" cast alike), calls ``fn``
on torch tensors and wraps what it returns.  Torch autograd records the
graph as ``fn`` runs, so there is no tape here.  With the
``check_nan_inf`` flag set, every floating output is swept for NaN/Inf
and a hit raises ``FloatingPointError`` naming the op.  An error inside
``fn`` is re-raised as ``RuntimeError("[operator < name >] ...")``.

While grad is recorded, ``fn`` runs under the tensor module's
``saved_tensors_hooks`` (a leaf written in place later hands the op the
value it saved), and each new node of an output gets a pre-hook that
raises the reference's ``RuntimeError`` (``paddle_tpu/autograd/tape.py:
84-100``) when a non-leaf input Tensor was written in place between the
op and its backward: the note ``[weakref, version]`` of each such input
rides on the output (``_paddle_notes``) so ``Tensor._replace_from`` can
refresh the note of the op whose result it adopts.

The JAX dispatcher's fallback for ops that run but cannot be linearized
is not ported: it exists for JAX's tracing, and torch autograd has no
such case.

While a static Program is being built (``static.program_guard``), ``apply``
hands the op to the Program, which records it and runs it once on
placeholders (the JAX package's recording hook, ``paddle_tpu/ops/
dispatch.py:42-49,163-171``)."""
from __future__ import annotations

import weakref

import torch

from ..amp.auto_cast import cast_inputs
from ..framework.flags import flag_value

__all__ = ["apply"]


def _check_nan_inf(name, outs):
    for i, o in enumerate(outs):
        if isinstance(o, torch.Tensor) and o.is_floating_point():
            if not bool(torch.isfinite(o).all()):
                raise FloatingPointError(
                    f"Operator {name} output #{i} contains NaN or Inf "
                    "(FLAGS_check_nan_inf is set)")


def _version_guard(name, notes):
    def prehook(grad_outputs):
        for ref, version in notes:
            t = ref()
            if t is not None and t._inplace_version != version:
                raise RuntimeError(
                    f"intermediate tensor used by operator < {name} > was "
                    "modified in-place after being recorded for backward "
                    f"(inplace version {t._inplace_version} != recorded "
                    f"{version}): its autograd identity changed, so the "
                    "recorded graph no longer matches the tensor you hold. "
                    "Clone it before the in-place write.")

    return prehook


def _note_versions(name, args, flat):
    """Note the version of each non-leaf input Tensor on the new nodes
    of the outputs (the reference's ``Edge.version``)."""
    from ..tensor import Tensor

    notes, seen = [], set()
    for a in args:
        if (isinstance(a, Tensor) and a._value.grad_fn is not None
                and id(a) not in seen):
            seen.add(id(a))
            notes.append([weakref.ref(a), a._inplace_version])
    if not notes:
        return
    # the nodes are held while compared: a node's Python object lives
    # only while referenced, so an id() could be a dead one's
    inputs = [a._value.grad_fn for a in args if isinstance(a, Tensor)]
    hooked = []
    for o in flat:
        node = o.grad_fn if isinstance(o, torch.Tensor) else None
        if node is None or any(node is n for n in inputs):
            continue
        if not any(node is n for n in hooked):
            hooked.append(node)
            node.register_prehook(_version_guard(name, notes))
        o._paddle_notes = notes


_RECORDER = []


def _recording_program():
    """The static Program being built, if any (``static/program.py`` —
    TraceOp's OpDesc-append analog, tracer.cc:205)."""
    if not _RECORDER:
        from ..static.program import _active_recorder

        _RECORDER.append(_active_recorder)
    return _RECORDER[0]()


def apply(name, fn, *args, **kwargs):
    """Run ``fn(*values, **kwargs)`` eagerly; returns a Tensor, or a
    tuple/list of Tensors mirroring ``fn``'s flat output.  While a
    static Program is being built the op is recorded into it instead,
    run once on placeholders (``Program.record``)."""
    from ..tensor import Tensor, pack_saved, unpack_saved

    recorder = _recording_program()
    if recorder is not None:
        return recorder.record(name, fn, args, kwargs)

    cast = iter(cast_inputs(name, *(a._value for a in args
                                     if isinstance(a, Tensor))))
    values = [next(cast) if isinstance(a, Tensor) else a for a in args]
    recording = torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in values)
    try:
        if recording:
            with torch.autograd.graph.saved_tensors_hooks(pack_saved,
                                                          unpack_saved):
                out = fn(*values, **kwargs)
        else:
            out = fn(*values, **kwargs)
    except Exception as e:
        raise RuntimeError(f"[operator < {name} >] {e}") from e
    single = not isinstance(out, (tuple, list))
    flat = (out,) if single else tuple(out)
    if recording:
        _note_versions(name, args, flat)
    if flag_value("check_nan_inf"):
        _check_nan_inf(name, flat)
    wrapped = [Tensor(o) if isinstance(o, torch.Tensor) else o
               for o in flat]
    return wrapped[0] if single else type(out)(wrapped)
