"""The two functionals of ``paddle_tpu/nn/functional/extension.py`` that
``nn.HSigmoidLoss`` and ``nn.NCELoss`` need: ``hsigmoid_loss``
(``:1031``) and ``nce`` (``:1070``).  The rest of that module (the fluid
surface) waits for ROADMAP item 13.

``nce`` draws its uniform negatives from the port's generator of the
input's device (``framework.random``), so they are not the JAX package's
threefry draws: the loss is the same function of the negatives, and the
same in distribution.  Each knob the JAX package accepts and never reads
raises ``InvalidArgumentError`` when set away from its default:
``hsigmoid_loss``'s ``path_table``, ``path_code`` and ``is_sparse``, and
``nce``'s ``sample_weight``, ``sampler``, ``custom_dist``, ``seed`` and
``is_sparse``."""
from __future__ import annotations

import math

import torch

from ...framework.errors import InvalidArgumentError
from ...framework.random import generator
from ...ops._helpers import to_tensor_like
from ...ops.dispatch import apply

__all__ = ["hsigmoid_loss", "nce"]


def _refuse(fn, **knobs):
    for knob, (value, default) in knobs.items():
        if (value is not None) if default is None else (value != default):
            raise InvalidArgumentError(
                f"{fn}({knob}=...) is not supported: the JAX package "
                "accepts it and never reads it (ROADMAP \"Known facts "
                "about the reference\")")


def _sigmoid_xent(logit, target):
    """``log(1 + exp(-|z|)) + max(z, 0) - z·t``."""
    return (torch.log1p(torch.exp(-torch.abs(logit)))
            + torch.clamp(logit, min=0) - logit * target)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss over the complete binary tree of
    ``num_classes`` leaves: ``weight [K-1, D]`` (and ``bias [K-1]``) per
    internal node; ``[B, 1]`` losses."""
    _refuse("hsigmoid_loss", path_table=(path_table, None),
            path_code=(path_code, None), is_sparse=(is_sparse, False))
    k = int(num_classes)
    depth = max(1, int(math.ceil(math.log2(max(k, 2)))))

    def f(v, lab, w, *mb):
        node = lab.reshape(-1).long() + k    # leaves at [K, 2K)
        loss = torch.zeros(v.shape[0], dtype=torch.float32, device=v.device)
        for _ in range(depth):
            parent = torch.div(node, 2, rounding_mode="floor")
            code = torch.remainder(node, 2).float()
            idx = torch.clamp(parent - 1, 0, w.shape[0] - 1)
            logit = (v * w[idx]).sum(dim=-1)
            if mb:
                logit = logit + mb[0].reshape(-1)[idx]
            step = _sigmoid_xent(logit, code)
            loss = loss + torch.where(parent >= 1, step,
                                      torch.zeros_like(step))
            node = parent
        return loss.reshape(-1, 1)

    args = [to_tensor_like(input), to_tensor_like(label),
            to_tensor_like(weight)]
    if bias is not None:
        args.append(to_tensor_like(bias))
    return apply("hsigmoid_loss", f, *args)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False,
        weight=None, bias=None):
    """Noise-contrastive estimation: per row the label and
    ``num_neg_samples`` uniform negatives, each scored against
    ``weight [K, D]`` (and ``bias [K]``), the logistic loss against the
    noise ``log(S/K)``; ``[B, 1]`` losses."""
    _refuse("nce", sample_weight=(sample_weight, None),
            sampler=(sampler, "uniform"), custom_dist=(custom_dist, None),
            seed=(seed, 0), is_sparse=(is_sparse, False))
    if weight is None:
        raise ValueError(
            "nce: pass weight=[num_total_classes, D] (and bias) "
            "explicitly — the param-creating fluid form")
    x = to_tensor_like(input)
    k, s = int(num_total_classes), int(num_neg_samples)
    gen = generator(x.place)

    def f(v, lab, w, *mb):
        b = v.shape[0]
        lab = lab.reshape(-1).long()
        neg = torch.randint(0, k, (b, s), generator=gen, device=v.device)
        ids = torch.cat([lab[:, None], neg], dim=1)          # [B, 1+S]
        logits = torch.einsum("bd,bsd->bs", v, w[ids])
        if mb:
            logits = logits + mb[0].reshape(-1)[ids]
        log_q = torch.log(torch.tensor(s / k, dtype=torch.float32,
                                       device=v.device))
        logits = logits - log_q
        target = torch.cat([torch.ones(b, 1, device=v.device),
                            torch.zeros(b, s, device=v.device)], dim=1)
        return _sigmoid_xent(logits, target).sum(dim=1, keepdim=True)

    args = [x, to_tensor_like(label), to_tensor_like(weight)]
    if bias is not None:
        args.append(to_tensor_like(bias))
    return apply("nce", f, *args)
