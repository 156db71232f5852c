"""Elementwise ``x * scale + shift`` — the port's twin of the worked
Pallas example of the custom-op API (``tests/test_custom_op.py:94``
``_pallas_scale_shift``, TPU kernel row t).

``out = x * scale[0] + shift[0]`` has x's shape and dtype; ``scale`` and
``shift`` hold one element each and stay on the device (the kernel reads
them there: no host sync).

- :func:`scale_shift` — the routing entry, the function a user registers
  with ``utils.register_op``: a CUDA tensor launches the hand-written
  kernel (``csrc/scale_shift.cu``), a CPU tensor runs the plain version.
- :func:`scale_shift_vjp` — its recompute-style gradient, the twin of
  ``_pallas_scale_shift_vjp``: dx is the kernel again with shift 0;
  dscale ``sum(ct·x)`` and dshift ``sum(ct)`` are torch reductions, as
  the JAX version leaves them to XLA.
- :func:`scale_shift_ref` — the plain version.
- :func:`scale_shift_cuda` — the kernel wrapper.

``SCALE_SHIFT_ROUTE_STATS`` counts ``"cuda"`` launches (by the wrapper,
once per launch) and ``"ref"`` plain calls (by the routing entry).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["SCALE_SHIFT_ROUTE_STATS", "scale_shift_ref", "scale_shift_cuda",
           "scale_shift", "scale_shift_vjp"]

SCALE_SHIFT_ROUTE_STATS = {"cuda": 0, "ref": 0}

_KERNEL_FNS = {torch.float32: "ptt_scale_shift_f32",
               torch.bfloat16: "ptt_scale_shift_bf16",
               torch.float16: "ptt_scale_shift_f16"}
_BOUND = {}


def scale_shift_ref(x, scale, shift):
    """Plain version: f32 product, then f32 sum, then one cast to x's
    dtype."""
    s = scale.reshape(()).float()
    b = shift.reshape(()).float()
    return (x.float() * s + b).to(x.dtype)


def _check(x, scale, shift):
    if x.dtype not in _KERNEL_FNS:
        raise ValueError(f"scale_shift takes float32, bfloat16 or float16 "
                         f"x, got {x.dtype}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.numel() != 1:
            raise ValueError(f"{name} must hold one element, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_floating_point():
            raise ValueError(f"{name} must be floating, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _kernel(dtype):
    """The C entry point for ``dtype``, built and bound at first use."""
    fn = _BOUND.get(dtype)
    if fn is None:
        from ._build import load_library

        fn = getattr(load_library("scale_shift"), _KERNEL_FNS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[dtype] = fn
    return fn


def scale_shift_cuda(x, scale, shift):
    """Launch the CUDA kernel (``csrc/scale_shift.cu``), which replaces
    the inline Pallas ``kernel`` of ``tests/test_custom_op.py:99``.

    x: a CUDA tensor, float32, bfloat16 or float16, any shape (made
    contiguous); scale, shift: one floating element each on x's device
    (read as float32 on the device).  An empty x launches nothing.
    Raises ``ValueError`` on another dtype or a scale/shift of more than
    one element, ``RuntimeError`` when the launch is refused."""
    _check(x, scale, shift)
    if not x.is_cuda:
        raise ValueError("scale_shift_cuda needs CUDA tensors")
    fn = _kernel(x.dtype)
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    s = scale.reshape(1).to(torch.float32).contiguous()
    b = shift.reshape(1).to(torch.float32).contiguous()
    vec_ok = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
                n, vec_ok, stream)
    if rc != 0:
        raise RuntimeError(f"scale_shift kernel launch failed: CUDA error "
                           f"{rc} (numel={n}, {x.dtype})")
    SCALE_SHIFT_ROUTE_STATS["cuda"] += 1
    return out


@torch.library.custom_op("paddle_tpu_torch::scale_shift", mutates_args=())
def _scale_shift_op(x: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return scale_shift_cuda(x, scale, shift)
    _check(x, scale, shift)
    SCALE_SHIFT_ROUTE_STATS["ref"] += 1
    return scale_shift_ref(x, scale, shift)


@_scale_shift_op.register_fake
def _scale_shift_fake(x, scale, shift):
    _check(x, scale, shift)
    return x.new_empty(x.shape)


def _scale_shift_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _scale_shift_backward(ctx, g):
    return scale_shift_vjp(g, *ctx.saved_tensors)


_scale_shift_op.register_autograd(_scale_shift_backward,
                                  setup_context=_scale_shift_setup)


def scale_shift(x, scale, shift):
    """Routing entry: ``x * scale[0] + shift[0]`` in x's dtype, the
    operator ``paddle_tpu_torch::scale_shift``.  A CUDA tensor launches
    the kernel; a CPU tensor runs the plain version; a tensor with no
    data gets the shape from the op's fake function."""
    return _scale_shift_op(x, scale, shift)


def scale_shift_vjp(ct, x, scale, shift):
    """Gradients of :func:`scale_shift` for ``register_op(vjp=...)``:
    (dx, dscale, dshift), the two sums shaped like scale and shift."""
    return (scale_shift(ct, scale, torch.zeros_like(shift)),
            torch.sum(ct * x).reshape(scale.shape),
            torch.sum(ct).reshape(shift.shape))
