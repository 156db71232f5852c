"""Fused training-mode batch norm with a hand-written backward — twin of
``paddle_tpu/ops/fused_norm.py`` (``fold_scale_shift``,
``bn_train_fused``).

The JAX op is a ``jax.custom_vjp`` left to XLA's fusions; here it is a
``torch.autograd.Function`` over plain PyTorch ops (no Pallas kernel
backs it, so there is no hand kernel to port; a fused Triton pass is a
later speed question, ROADMAP).  The semantics are the JAX op's:

- statistics in f32 whatever the input's dtype, the output in the
  input's dtype (bf16 under AMP);
- the shifted single-pass variance ``E[(x-p)^2] - (mean-p)^2`` with the
  layer's running mean as the pivot ``p`` (a constant: no gradient), so
  the variance differs from a two-pass one in its last bits exactly as
  the JAX op's does, and it is the biased (population) variance;
- an optional ReLU folded into the output, its gate recomputed in the
  backward from ``x`` and the folded per-channel scale and shift;
- the closed-form backward, which keeps only ``(x, mean, inv, weight,
  bias)``: no normalized activation, no ReLU mask.  Per channel, with
  ``n`` reduced elements and ``g`` gated by the ReLU::

      db = sum(g)
      dw = sum(g * (x - mean)) * inv
      dx = w*inv * g - w*inv^2*dw/n * (x - mean) - w*inv*db/n

  (the JAX op writes the same sums around the pivot; the port centres
  them on the batch mean, which it keeps, so it need not keep the pivot:
  the running mean it was read from is updated in place after the
  forward).
"""
from __future__ import annotations

import torch

__all__ = ["fold_scale_shift", "bn_train_fused"]


def fold_scale_shift(m, inv, weight, bias):
    """Per-channel statistics (mean, rsqrt(var + eps)) and the affine
    folded into (scale, shift) in f32 — shared by the training op and
    the global-statistics path, so the two cannot diverge."""
    scale = inv * weight.float() if weight is not None else inv
    shift = -m * scale
    if bias is not None:
        shift = shift + bias.float()
    return scale, shift


def _per_channel(v, ndim, ch_axis):
    shape = [1] * ndim
    shape[ch_axis] = -1
    return v.reshape(shape)


class _BatchNormTrain(torch.autograd.Function):
    """(x, weight, bias, pivot) -> (out, batch mean, batch variance); the
    mean and variance only feed the running statistics and carry no
    gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, pivot, axes, ch_axis, eps, relu):
        n = 1
        for a in axes:
            n *= x.shape[a]
        nd = x.dim()
        # x - pivot in f32 (a bf16 x is promoted exactly)
        d = x - _per_channel(pivot, nd, ch_axis)
        s1 = d.sum(dim=axes)
        s2 = (d * d).sum(dim=axes)
        del d
        dm = s1 / n                         # mean(x) - pivot
        m = dm + pivot
        var = torch.clamp_min(s2 / n - dm * dm, 0.0)
        inv = torch.rsqrt(var + eps)
        scale, shift = fold_scale_shift(m, inv, weight, bias)
        # f32 arithmetic; the add writes the input's dtype and memory
        # format (its rounding is the JAX op's final cast), and the ReLU
        # after that rounding gives the same bits as before it
        out = torch.empty_like(x)
        torch.add(x * _per_channel(scale, nd, ch_axis),
                  _per_channel(shift, nd, ch_axis), out=out)
        if relu:
            out.clamp_min_(0.0)
        ctx.save_for_backward(x, m, inv, weight, bias)
        ctx.axes, ctx.ch_axis, ctx.n, ctx.relu = axes, ch_axis, n, relu
        ctx.mark_non_differentiable(m, var)
        return out, m, var

    @staticmethod
    def backward(ctx, g, _dm, _dvar):
        x, m, inv, weight, bias = ctx.saved_tensors
        axes, ch_axis, n = ctx.axes, ctx.ch_axis, ctx.n
        nd = x.dim()
        # g stays in its dtype: every product with an f32 operand runs in
        # f32, the sums accumulate in f32, and dx is written in x's dtype
        # by the last op (no cast passes)
        if ctx.relu:
            # the ReLU's gate from x and the folded constants: no mask kept
            scale, shift = fold_scale_shift(m, inv, weight, bias)
            pre = (x * _per_channel(scale, nd, ch_axis)
                   + _per_channel(shift, nd, ch_axis))
            g = torch.where(pre > 0, g, 0.0)
            del pre
        xc = x - _per_channel(m, nd, ch_axis)
        sg = g.sum(dim=axes, dtype=torch.float32)
        dw = (g * xc).sum(dim=axes, dtype=torch.float32) * inv
        w32 = weight.float() if weight is not None else torch.ones_like(inv)
        c1 = w32 * inv
        c2 = -w32 * inv * inv * dw / n
        c3 = -c1 * sg / n
        dx = torch.empty_like(x)
        torch.add(g * _per_channel(c1, nd, ch_axis)
                  + xc * _per_channel(c2, nd, ch_axis),
                  _per_channel(c3, nd, ch_axis), out=dx)
        dweight = dw.to(weight.dtype) if weight is not None else None
        dbias = sg.to(bias.dtype) if bias is not None else None
        return dx, dweight, dbias, None, None, None, None, None


def bn_train_fused(x, weight, bias, axes, ch_axis, eps, relu=False,
                   pivot=None):
    """Training batch norm over ``axes`` (optionally fused with ReLU):
    returns ``(out, batch_mean, batch_var)``, the statistics in f32.

    ``pivot`` (per channel, e.g. the running mean; a constant) steadies
    the single-pass variance; zeros by default.  ``weight`` and ``bias``
    may be None."""
    C = x.shape[ch_axis]
    if pivot is None:
        pivot = torch.zeros((C,), dtype=torch.float32, device=x.device)
    pivot = pivot.detach().float()
    ch = ch_axis % x.dim()
    return _BatchNormTrain.apply(x, weight, bias, pivot,
                                 tuple(a % x.dim() for a in axes), ch,
                                 float(eps), bool(relu))
