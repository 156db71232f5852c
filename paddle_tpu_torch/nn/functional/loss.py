"""Loss functionals — twin of ``paddle_tpu/nn/functional/loss.py``, the
hard-label softmax cross entropy the GPT training slice needs."""
from __future__ import annotations

import torch

from ...framework.errors import InvalidArgumentError

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Hard-label softmax cross entropy in the lse form:
    ``loss_i = lse(logits_i) - logits_i[label_i]``; with
    ``label_smoothing`` ε, ``(1 - ε)·loss_i + ε·(lse_i - mean(logits_i))``.
    The logits are read in f32 and only ``[.., 1]``-shaped reductions are
    kept for the backward — no f32 ``[tokens, V]`` log_softmax is saved.

    Labels equal to ``ignore_index`` contribute 0; ``reduction="mean"``
    divides by the count of valid labels (at least 1), ``"sum"`` sums,
    ``"none"`` returns the per-label losses.  A label tensor with the
    logits' rank is squeezed along ``axis``.  ``weight``, ``soft_label``
    and ``use_softmax=False`` are not ported (ROADMAP queue 1 item 9)."""
    if weight is not None or soft_label or not use_softmax:
        raise InvalidArgumentError(
            "cross_entropy with weight, soft_label or use_softmax=False is "
            "not ported yet (ROADMAP queue 1 item 9)")
    if reduction not in ("mean", "sum", "none"):
        raise InvalidArgumentError(
            f"reduction must be 'mean', 'sum' or 'none', got {reduction!r}")
    axis = axis % input.dim()
    x32 = input.float().movedim(axis, -1)
    idx = label.long()
    if idx.dim() == input.dim():
        idx = idx.squeeze(axis)
    valid = idx != ignore_index
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    lse = torch.logsumexp(x32, dim=-1)
    picked = torch.gather(x32, -1, safe[..., None])[..., 0]
    loss = lse - picked
    if label_smoothing > 0.0:
        mean_nll = lse - x32.mean(dim=-1)
        loss = (1 - label_smoothing) * loss + label_smoothing * mean_nll
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        denom = torch.clamp(valid.float().sum(), min=1.0)
        return loss.sum() / denom
    if reduction == "sum":
        return loss.sum()
    return loss
