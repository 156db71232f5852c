"""Normalization functionals — twin of ``paddle_tpu/nn/functional/norm.py``:
``batch_norm``, ``layer_norm``, ``instance_norm``, ``group_norm``,
``local_response_norm`` and ``normalize``, dispatched under the JAX
package's op names ("batch_norm", "layer_norm", "instance_norm",
"group_norm", "lrn", "normalize").  None of them is on an AMP list: each
keeps its statistics in f32 and returns its input's dtype.

``batch_norm`` carries the JAX op over, not ATen's: paddle's
``momentum`` is the share of the running statistic that is KEPT
(``new = momentum * old + (1 - momentum) * batch``; torch's momentum is
the share taken), the running variance takes the biased batch variance
of the shifted single-pass form (``ops/fused_norm.py``), and the
training form with ``act="relu"`` is one autograd op.  The running
statistics are updated IN PLACE on their device (``mul_``, ``add_``),
never rebound, so a CUDA graph that captured the step updates them at
every replay."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework.errors import InvalidArgumentError
from ...ops._helpers import to_tensor_like
from ...ops.dispatch import apply
from ...ops.fused_norm import _per_channel, bn_train_fused, fold_scale_shift

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm", "normalize"]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, act=None,
               name=None):
    """Batch norm over every axis but the channel one (axis 1 for NCHW,
    NCL, NCDHW and NC; the last axis otherwise).  With batch statistics
    (``training`` and not ``use_global_stats``) it also updates
    ``running_mean`` / ``running_var`` in place; with the running ones
    the statistics and the affine fold into one scale and shift.
    ``act="relu"`` folds a ReLU in."""
    x = to_tensor_like(x)
    rm, rv = to_tensor_like(running_mean), to_tensor_like(running_var)
    if use_global_stats is None:
        use_global_stats = not training
    if act not in (None, "relu"):
        raise ValueError(f"batch_norm act must be None or 'relu', got {act!r}")
    nd = x.ndim
    ch_axis = 1 if data_format in ("NCHW", "NCL", "NCDHW", "NC") else nd - 1
    axes = tuple(i for i in range(nd) if i != ch_axis)
    has_w, has_b = weight is not None, bias is not None
    extra = ([to_tensor_like(weight)] if has_w else []) + \
            ([to_tensor_like(bias)] if has_b else [])

    def _unpack(wb):
        return (wb[0] if has_w else None), (wb[-1] if has_b else None)

    if use_global_stats:
        def f_infer(v, m, var, *wb):
            w_arr, b_arr = _unpack(wb)
            inv = torch.rsqrt(var.float() + epsilon)
            scale, shift = fold_scale_shift(m.float(), inv, w_arr, b_arr)
            out = (v * _per_channel(scale, nd, ch_axis).to(v.dtype)
                   + _per_channel(shift, nd, ch_axis).to(v.dtype))
            if act == "relu":
                out = torch.clamp_min(out, 0)
            return out

        return apply("batch_norm", f_infer, x, rm, rv, *extra)

    def f_train(v, pivot, *wb):
        w_arr, b_arr = _unpack(wb)
        return bn_train_fused(v, w_arr, b_arr, axes, ch_axis, epsilon,
                              relu=(act == "relu"), pivot=pivot)

    out, m, var = apply("batch_norm", f_train, x, rm, *extra)
    with torch.no_grad():
        for stat, batch in ((rm._value, m._value), (rv._value, var._value)):
            stat.mul_(momentum).add_(batch.to(stat.dtype) * (1 - momentum))
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm over the trailing axes ``normalized_shape`` names, with
    f32 statistics and population variance, cast back to x's dtype.  On
    a plain torch tensor (the torch-module ``GPTModel``) it returns one;
    the serving path's ``_ln`` is the arithmetic."""
    shape = ((normalized_shape,) if isinstance(normalized_shape, int)
             else tuple(normalized_shape))
    if tuple(x.shape[len(x.shape) - len(shape):]) != shape:
        raise InvalidArgumentError(
            f"layer_norm over {shape} of a {tuple(x.shape)} input: the "
            "normalized shape must be the input's trailing axes")
    from ...text.generation import _ln

    dims = tuple(range(-len(shape), 0))
    has_w, has_b = weight is not None, bias is not None

    def f(v, *wb):
        return _ln(v, wb[0] if has_w else 1.0, wb[-1] if has_b else 0.0,
                   epsilon, dims)

    wb = [t for t in (weight, bias) if t is not None]
    if isinstance(x, torch.Tensor):
        return f(x, *wb)
    return apply("layer_norm", f, to_tensor_like(x),
                 *map(to_tensor_like, wb))


def _affine(out, wb, has_w, has_b, nd, ch_axis):
    if has_w:
        out = out * _per_channel(wb[0].float(), nd, ch_axis)
    if has_b:
        out = out + _per_channel(wb[-1].float(), nd, ch_axis)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Normalize each sample's channel over its spatial axes (f32
    statistics, population variance).  The JAX package always uses the
    input's statistics and ignores running ones: the port raises where a
    caller asks for them (ROADMAP queue 1 item 8)."""
    if not use_input_stats or running_mean is not None \
            or running_var is not None:
        raise InvalidArgumentError(
            "instance_norm with running statistics is not ported (the JAX "
            "package ignores them; ROADMAP queue 1 item 8)")
    x = to_tensor_like(x)
    nd = x.ndim
    ch_axis = 1 if data_format.startswith("NC") else nd - 1
    axes = (tuple(range(2, nd)) if ch_axis == 1
            else tuple(range(1, nd - 1)))
    has_w, has_b = weight is not None, bias is not None

    def f(v, *wb):
        vf = v.float()
        var, m = torch.var_mean(vf, dim=axes, correction=0, keepdim=True)
        out = (vf - m) * torch.rsqrt(var + eps)
        return _affine(out, wb, has_w, has_b, nd, ch_axis).to(v.dtype)

    args = [x] + [to_tensor_like(t) for t in (weight, bias) if t is not None]
    return apply("instance_norm", f, *args)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalize each sample over groups of ``C / num_groups`` channels
    and the spatial axes (f32 statistics, population variance)."""
    x = to_tensor_like(x)
    channel_last = not data_format.startswith("NC")
    has_w, has_b = weight is not None, bias is not None

    def f(v, *wb):
        vf = v.float()
        if channel_last:
            vf = vf.movedim(-1, 1)
        N, C = vf.shape[0], vf.shape[1]
        rest = vf.shape[2:]
        g = vf.reshape(N, num_groups, C // num_groups, *rest)
        var, m = torch.var_mean(g, dim=tuple(range(2, g.dim())),
                                correction=0, keepdim=True)
        out = ((g - m) * torch.rsqrt(var + epsilon)).reshape(N, C, *rest)
        out = _affine(out, wb, has_w, has_b, out.dim(), 1)
        if channel_last:
            out = out.movedim(1, -1)
        return out.to(v.dtype)

    args = [x] + [to_tensor_like(t) for t in (weight, bias) if t is not None]
    return apply("group_norm", f, *args)


def local_response_norm(x, size, alpha=0.0001, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s) ** beta``, ``s`` the sum of squares over a
    window of ``size`` channels (zero-padded ``size // 2`` before and
    ``size - 1 - size // 2`` after), in f32."""
    x = to_tensor_like(x)
    ch_axis = 1 if data_format.startswith("NC") else x.ndim - 1

    def f(v):
        sq = v.float().square().movedim(ch_axis, -1)
        half = size // 2
        s = TF.pad(sq, (half, size - 1 - half)).unfold(-1, size, 1).sum(-1)
        div = torch.pow(k + alpha * s.movedim(-1, ch_axis), beta)
        return (v.float() / div).to(v.dtype)

    return apply("lrn", f, x)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    x = to_tensor_like(x)

    def f(v):
        n = (v.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
        return v / torch.clamp_min(n, epsilon)

    return apply("normalize", f, x)
