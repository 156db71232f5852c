"""Gradient clipping — twin of ``paddle_tpu/nn/clip_grad.py``
(``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``).

A clip takes ``[(param, grad), ...]`` and returns the list with each
clippable gradient replaced.  Gradients are torch tensors (or port
``Tensor``s, returned as such); a parameter whose ``need_clip`` is
False, or whose gradient is None, passes through.  Everything runs on
the gradients' device and reads nothing back to the host: the global
norm's scale is the branch-free ``clip / max(norm, clip)`` (that is,
``min(1, clip / norm)``), so a clip can sit inside a CUDA graph of the
training step.  The expressions and the order of the sums are the JAX
package's, in f32."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


def _unwrap(g):
    from ..tensor import Tensor

    return (g._value, Tensor) if isinstance(g, Tensor) else (g, None)


def _clippable(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        with torch.no_grad():
            return self._clip(list(params_grads))

    def _clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clippable(p, g):
                out.append((p, g))
                continue
            v, wrap = _unwrap(g)
            v = torch.clamp(v, self.min, self.max)
            out.append((p, wrap(v) if wrap else v))
        return out


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clippable(p, g):
                out.append((p, g))
                continue
            v, wrap = _unwrap(g)
            n = torch.sqrt(torch.sum(torch.square(v.float())))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            v = (v * scale).to(v.dtype)
            out.append((p, wrap(v) if wrap else v))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def global_norm(self, params_grads):
        """The f32 L2 norm over every clippable gradient (a 0-d device
        tensor), or None when there is none; the squares summed tensor by
        tensor in list order."""
        sq = None
        for p, g in params_grads:
            if _clippable(p, g):
                s = torch.sum(torch.square(_unwrap(g)[0].float()))
                sq = s if sq is None else sq + s
        return None if sq is None else torch.sqrt(sq)

    def _clip(self, params_grads):
        norm = self.global_norm(params_grads)
        if norm is None:
            return params_grads
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        out = []
        for p, g in params_grads:
            if not _clippable(p, g):
                out.append((p, g))
                continue
            v, wrap = _unwrap(g)
            v = (v * scale).to(v.dtype)
            out.append((p, wrap(v) if wrap else v))
        return out
