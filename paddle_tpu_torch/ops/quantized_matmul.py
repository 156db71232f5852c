"""Weight-only int8 matmul ``x @ dequant(w)`` — the counterpart of
``paddle_tpu/ops/pallas_ops/quantized_matmul.py``.

Weights stay resident as int8 ``w_q [K, N]`` with one fp32 dequant scale
per output channel ``w_scale [N]`` (the JAX layout, which is also the
kernel's: no re-layout anywhere); activations stay in their own dtype
and the product accumulates in f32, the scale applied once after the
K-sum.

- :func:`quantized_matmul` — the routing entry the serving core calls:
  a CUDA tensor launches the hand-written kernel
  (``csrc/quantized_matmul.cu``), a CPU tensor runs the plain version.
  Leading dims of ``x`` are flattened around the 2-D product.
- :func:`quantized_matmul_ref` — the plain twin of
  ``quantized_matmul_xla``.
- :func:`quantized_matmul_cuda` — the kernel wrapper.

``QMM_ROUTE_STATS`` counts ``"cuda"`` launches (incremented by the
wrapper, once per launch) and ``"ref"`` plain-version calls (by the
routing entry); ``QMM_FORM_STATS`` counts the same launches by the form
of the kernel that ran (:func:`qmm_form`).

The kernel sums in one canonical order, a function of K alone: chunks of
``QMM_KC`` values of k, each summed in sequential k order from 0, the
chunk partials added in chunk order from 0, then the scale.  Its decode
form (M <= ``QMM_DECODE_MAX_M``) splits K over blocks, writes the chunk
partials to a scratch, and a second pass adds them in chunk order; its
prefill form splits K over the four warps of a block, whose chunk
partials join each output's total in chunk order.  Both give a row the
same bits whatever M and whatever the other rows of the launch.
"""
from __future__ import annotations

import ctypes

import torch

from ..profiler.jit_cost import count_launch

__all__ = ["QMM_ROUTE_STATS", "QMM_FORM_STATS", "QMM_KC",
           "QMM_DECODE_MAX_M", "qmm_form", "quantized_matmul_ref",
           "quantized_matmul_cuda", "quantized_matmul"]

# counted through ``count_launch``: the CUDA-graph runner adds a captured
# program's launches on every replay
QMM_ROUTE_STATS = {"cuda": 0, "ref": 0}
QMM_FORM_STATS = {"decode": 0, "prefill": 0}

# the kernel's contract (csrc/quantized_matmul.cu, checked when it binds):
# the chunk of K its canonical order sums, and the largest M of its
# split-K decode form
QMM_KC = 64
QMM_DECODE_MAX_M = 16

_KERNEL_FNS = {torch.float32: "ptt_quantized_matmul_f32",
               torch.bfloat16: "ptt_quantized_matmul_bf16"}
_BOUND = {}


def quantized_matmul_ref(x, w_q, w_scale):
    """Plain twin of ``quantized_matmul_xla``: dequantize-then-matmul in
    f32, the per-channel scale folded after the K-sum, cast to x's
    dtype.  x [M, K], w_q [K, N] int8, w_scale [N] -> [M, N]."""
    acc = x.float() @ w_q.float()
    return (acc * w_scale.float()[None, :]).to(x.dtype)


def qmm_form(M: int) -> str:
    """The form of the kernel a launch of M rows takes: ``"decode"``
    (split-K, M <= QMM_DECODE_MAX_M) or ``"prefill"`` (register-tiled)."""
    return "decode" if M <= QMM_DECODE_MAX_M else "prefill"


def _check(x, w_q, w_scale):
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"x must be [M, K] and w_q [K, N]; got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    M, K = x.shape
    Kw, N = w_q.shape
    if Kw != K:
        raise ValueError(f"x [{M},{K}] vs w_q [{Kw},{N}]: K mismatch")
    if tuple(w_scale.shape) != (N,):
        raise ValueError(f"w_scale must be [N={N}], got "
                         f"{tuple(w_scale.shape)}")
    if x.dtype not in _KERNEL_FNS:
        raise TypeError(f"quantized matmul kernel takes float32 or "
                        f"bfloat16 activations, got {x.dtype}")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError(f"w_q must be int8 and w_scale float32, got "
                        f"{w_q.dtype} and {w_scale.dtype}")
    for name, t in (("w_q", w_q), ("w_scale", w_scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w_q", w_q), ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel(dtype):
    """The C entry point for ``dtype``, built and bound at first use."""
    fn = _BOUND.get(dtype)
    if fn is None:
        from ._build import load_library

        lib = load_library("quantized_matmul")
        have = (lib.ptt_quantized_matmul_chunk(),
                lib.ptt_quantized_matmul_decode_max_m())
        if have != (QMM_KC, QMM_DECODE_MAX_M):
            raise RuntimeError(f"csrc/quantized_matmul.cu has (KC, decode "
                               f"max M) = {have}, the wrapper "
                               f"{(QMM_KC, QMM_DECODE_MAX_M)}")
        fn = getattr(lib, _KERNEL_FNS[dtype])
        # pointers and the stream as c_void_p (a plain int would be cut
        # to a 32-bit C int)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[dtype] = fn
    return fn


def quantized_matmul_cuda(x, w_q, w_scale):
    """Launch the CUDA kernel (``csrc/quantized_matmul.cu``), which
    replaces ``paddle_tpu/ops/pallas_ops/quantized_matmul.py:_qmm_kernel``.

    At decode (M = a few lane rows) the product is bound by the int8
    weight bytes; at a prefill chunk (M up to 512) by f32 FMAs.  Up to
    QMM_DECODE_MAX_M rows take the split-K decode form, whose chunk
    partials go to an f32 scratch ``[ceil(K / QMM_KC), M, N]`` allocated
    here; more rows take the register-tiled prefill form.  Both sum in
    the canonical chunk order, so an output row does not depend on which
    other rows share the launch.

    Inputs: contiguous CUDA tensors on one device, x f32 or bf16 [M, K],
    w_q int8 [K, N], w_scale f32 [N].  Raises when the launch is
    refused."""
    _check(x, w_q, w_scale)
    if not x.is_cuda:
        raise ValueError("quantized_matmul_cuda needs CUDA tensors")
    fn = _kernel(x.dtype)
    M, K = x.shape
    N = w_q.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    form = qmm_form(M)
    part = None
    if form == "decode":
        part = torch.empty((-(-K // QMM_KC), M, N), dtype=torch.float32,
                           device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                None if part is None else part.data_ptr(), out.data_ptr(),
                M, K, N, stream)
    if rc != 0:
        raise RuntimeError(
            f"quantized matmul kernel launch failed: CUDA error {rc} "
            f"(M={M}, K={K}, N={N}, {x.dtype}, {form} form)")
    count_launch(QMM_ROUTE_STATS, "cuda")
    count_launch(QMM_FORM_STATS, form)
    return out


@torch.library.custom_op("paddle_tpu_torch::quantized_matmul",
                         mutates_args=())
def _qmm_op(x: torch.Tensor, w_q: torch.Tensor,
            w_scale: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return quantized_matmul_cuda(x.contiguous(), w_q, w_scale)
    count_launch(QMM_ROUTE_STATS, "ref")
    return quantized_matmul_ref(x, w_q, w_scale)


@_qmm_op.register_fake
def _qmm_fake(x, w_q, w_scale):
    return x.new_empty((x.shape[0], w_q.shape[1]))


def _qmm_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _qmm_backward(ctx, g):
    # the plain version's gradients: dx = g · (w_q ⊙ w_scale)ᵀ and
    # dscale = Σ_rows g ⊙ (x · w_q); w_q is integer and gets none
    x, w_q, w_scale = ctx.saved_tensors
    dx = dscale = None
    if ctx.needs_input_grad[0]:
        w = w_q.float() * w_scale.float()[None, :]
        dx = (g.float() @ w.t()).to(x.dtype)
    if ctx.needs_input_grad[2]:
        dscale = ((x.float() @ w_q.float()) * g.float()).sum(0).to(
            w_scale.dtype)
    return dx, None, dscale


_qmm_op.register_autograd(_qmm_backward, setup_context=_qmm_setup)


def quantized_matmul(x, w_q, w_scale):
    """Routing entry (the serving transformer core calls this).

    x [..., K] activations, w_q [K, N] int8, w_scale [N] f32; returns
    [..., N] in x's dtype.  The operator
    ``paddle_tpu_torch::quantized_matmul``: a CUDA tensor launches the
    kernel, a CPU tensor runs the plain version, a tensor with no data
    gets the shape from the op's fake function (so an exported program
    keeps the op and picks its route where it runs)."""
    lead = x.shape[:-1]
    out = _qmm_op(x.reshape(-1, x.shape[-1]), w_q, w_scale)
    return out.reshape(*lead, w_q.shape[1])
