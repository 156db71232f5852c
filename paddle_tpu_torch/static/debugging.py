"""``static.Print`` — twin of ``paddle_tpu/static/debugging.py``
(reference: operators/print_op.cc + lodtensor_printer.cc): an identity
op that prints its tensor when the computation RUNS, forward and/or
backward — eagerly, at every ``Executor.run`` replay of a recorded
Program (the reference's RunImpl printing) and in ``to_static``; never
on a build-time placeholder or while ``torch.export`` traces (there is
no value then).  The printing happens on the host, so each print reads
the tensor back."""
from __future__ import annotations

import sys
import threading

import numpy as np
import torch


def _format(value, name, message, summarize, show_name, show_dtype,
            show_shape, phase):
    arr = np.asarray(value)
    parts = []
    if message:
        parts.append(str(message))
    if phase:
        parts.append(f"[{phase}]")
    if show_name and name:
        parts.append(f"Variable: {name}")
    if show_dtype:
        parts.append(f"dtype: {arr.dtype}")
    if show_shape:
        parts.append(f"shape: {list(arr.shape)}")
    # summarize=-1: print EVERYTHING (reference print_op semantics)
    threshold = arr.size + 1 if summarize <= 0 else summarize
    edge = arr.size if summarize <= 0 else max(1, summarize // 2)
    with np.printoptions(threshold=threshold, edgeitems=edge):
        parts.append(f"data: {arr}")
    return "  ".join(parts)


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=False,
          print_tensor_lod=False, print_phase="both"):
    """paddle.static.Print parity: identity op printing ``input`` (to
    stderr) when the computation runs.  ``first_n`` caps the number of
    prints; ``print_phase`` chooses forward values, backward gradients,
    or both."""
    from ..framework.export_compat import exporting, is_placeholder
    from ..ops._helpers import to_tensor_like
    from ..ops.dispatch import apply

    input = to_tensor_like(input)
    assert print_phase in ("forward", "backward", "both"), print_phase
    name = getattr(input, "name", None)
    lock = threading.Lock()
    counts = {"forward": 0, "backward": 0}

    def emit(value, phase):
        if exporting() or is_placeholder(value):
            return
        with lock:
            if 0 <= first_n <= counts[phase]:
                return
            counts[phase] += 1
        v = value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        sys.stderr.write(_format(v.cpu().numpy(), name, message, summarize,
                                 print_tensor_name, print_tensor_type,
                                 print_tensor_shape, phase) + "\n")
        sys.stderr.flush()

    class PrintOp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v):
            if print_phase in ("forward", "both"):
                emit(v, "forward")
            return v.view_as(v)

        @staticmethod
        def backward(ctx, g):
            if print_phase in ("backward", "both"):
                emit(g, "backward")
            return g

    def op(v):
        if exporting():
            return v.clone()
        return PrintOp.apply(v)

    return apply("print", op, input)
