"""Loss functionals — twin of ``paddle_tpu/nn/functional/loss.py``.

Each takes port ``Tensor``s (the dygraph core: dispatched through
``ops.dispatch.apply`` under the JAX package's op names, returning a
Tensor) or torch tensors (returning one); numpy inputs become Tensors on
the default place.  The expressions are the JAX package's, in f32 where
it reads f32.

``cross_entropy``'s hard-label softmax path is the lse form
``loss_i = lse(logits_i) - logits_i[label_i]`` (only ``[.., 1]``-shaped
reductions are kept for the backward); soft labels, ``use_softmax=False``
(the input is a probability) and per-class ``weight`` take the
log-probability form, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ...framework.errors import InvalidArgumentError

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "square_error_cost",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "npair_loss",
           "log_loss", "ctc_loss", "dice_loss", "sigmoid_focal_loss"]


def _dispatch(name, fn, *args):
    """``fn`` on the torch values of ``args``: through ``apply`` (a
    Tensor result) when any argument is a port Tensor or none is a torch
    tensor, else directly (a torch result).  Arrays and numbers go to
    the device of the first tensor argument."""
    from ...ops._helpers import to_tensor_like
    from ...ops.dispatch import apply
    from ...tensor import Tensor

    dev = next((a.place if isinstance(a, Tensor) else a.device
                for a in args if isinstance(a, (Tensor, torch.Tensor))),
               None)

    def conv(a):
        if isinstance(a, (Tensor, torch.Tensor)) or dev is None:
            return a
        return torch.as_tensor(np.asarray(a), device=dev)

    args = [conv(a) for a in args]
    if dev is not None and not any(isinstance(a, Tensor) for a in args):
        return fn(*args)
    return apply(name, fn, *[to_tensor_like(a) for a in args])


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy over ``axis``.  Hard labels (int, with
    ``input``'s rank less one, or the same rank with a 1 on ``axis``)
    equal to ``ignore_index`` contribute 0, and ``reduction="mean"``
    divides by the count of valid labels (at least 1) — or by the sum of
    their class weights when ``weight`` is given.  ``soft_label``: the
    label is a distribution over ``axis``.  ``use_softmax=False``: the
    input is a probability (log of at least 1e-30).
    ``label_smoothing`` ε mixes ``ε / C`` into the target.

    On a port ``Tensor`` it dispatches as "cross_entropy" (AMP black
    list)."""
    if reduction not in ("mean", "sum", "none"):
        raise InvalidArgumentError(
            f"reduction must be 'mean', 'sum' or 'none', got {reduction!r}")

    def f(logits, lab, *maybe_w):
        ax = axis % logits.dim()
        x32 = logits.float().movedim(ax, -1)
        n_classes = x32.shape[-1]
        if soft_label:
            soft = lab.float().movedim(ax, -1)
            if label_smoothing > 0.0:
                soft = soft * (1 - label_smoothing) \
                    + label_smoothing / n_classes
            logp = (torch.log_softmax(x32, dim=-1) if use_softmax
                    else torch.log(torch.clamp(x32, min=1e-30)))
            loss = -torch.sum(soft * logp, dim=-1)
            valid = torch.ones_like(loss, dtype=torch.bool)
            safe = None
        else:
            idx = lab.long()
            if idx.dim() == logits.dim():
                idx = idx.squeeze(ax)
            valid = idx != ignore_index
            safe = torch.where(valid, idx, torch.zeros_like(idx))
            if use_softmax:
                lse = torch.logsumexp(x32, dim=-1)
                picked = torch.gather(x32, -1, safe[..., None])[..., 0]
                loss = lse - picked
                if label_smoothing > 0.0:
                    mean_nll = lse - x32.mean(dim=-1)
                    loss = (1 - label_smoothing) * loss \
                        + label_smoothing * mean_nll
            else:
                logp = torch.log(torch.clamp(x32, min=1e-30))
                if label_smoothing > 0.0:
                    one_hot = torch.nn.functional.one_hot(
                        safe, n_classes).float()
                    soft = one_hot * (1 - label_smoothing) \
                        + label_smoothing / n_classes
                    loss = -torch.sum(soft * logp, dim=-1)
                else:
                    loss = -torch.gather(logp, -1, safe[..., None])[..., 0]
            loss = torch.where(valid, loss, torch.zeros_like(loss))
        if maybe_w:
            w = maybe_w[0].float()
            if soft_label:
                wl = torch.sum(lab.float().movedim(ax, -1) * w, dim=-1)
            else:
                wl = torch.where(valid, w[safe], torch.zeros_like(loss))
            loss = loss * wl
            if reduction == "mean":
                return torch.sum(loss) / torch.clamp(torch.sum(wl),
                                                     min=1e-12)
        if reduction == "mean":
            denom = torch.clamp(valid.float().sum(), min=1.0)
            return loss.sum() / denom
        return _reduce(loss, reduction)

    args = [input, label] + ([] if weight is None else [weight])
    return _dispatch("cross_entropy", f, *args)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """``cross_entropy(reduction="none")`` with the class axis kept as
    a 1; with ``return_softmax`` also the softmax."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = _dispatch("unsqueeze2", lambda v: v.unsqueeze(axis), loss)
    if return_softmax:
        from .activation import softmax

        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean", name=None):
    def f(logp, lab, *maybe_w):
        idx = lab.long()
        valid = idx != ignore_index
        safe = torch.where(valid, idx, torch.zeros_like(idx))
        loss = -torch.gather(logp, 1, safe.unsqueeze(1)).squeeze(1)
        wl = torch.where(valid, 1.0, 0.0).to(loss.dtype)
        if maybe_w:
            wl = wl * maybe_w[0][safe]
        loss = loss * wl
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp(torch.sum(wl), min=1e-12)
        return _reduce(loss, reduction)

    args = [input, label] + ([] if weight is None else [weight])
    return _dispatch("nll_loss", f, *args)


def mse_loss(input, label, reduction="mean", name=None):
    return _dispatch("mse_loss", lambda a, b: _reduce(torch.square(a - b),
                                                      reduction),
                     input, label)


def l1_loss(input, label, reduction="mean", name=None):
    return _dispatch("l1_loss", lambda a, b: _reduce(torch.abs(a - b),
                                                     reduction),
                     input, label)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def f(a, b):
        d = torch.abs(a - b)
        loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
        # paddle's huber_loss · delta
        return _reduce(loss * delta, reduction)

    return _dispatch("smooth_l1_loss", f, input, label)


def square_error_cost(input, label):
    return _dispatch("square_error_cost", lambda a, b: torch.square(a - b),
                     input, label)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def f(p, y, *maybe_w):
        p = torch.clamp(p.float(), 1e-12, 1.0 - 1e-7)
        loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        if maybe_w:
            loss = loss * maybe_w[0]
        return _reduce(loss, reduction)

    args = [input, label] + ([] if weight is None else [weight])
    return _dispatch("bce_loss", f, *args)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    def f(z, y, *rest):
        zf, yf = z.float(), y.float()
        # stable: max(z, 0) - z·y + log(1 + exp(-|z|))
        loss = torch.clamp(zf, min=0) - zf * yf \
            + torch.log1p(torch.exp(-torch.abs(zf)))
        i = 0
        if pos_weight is not None:
            pw = rest[i]
            i += 1
            log_weight = (pw - 1) * yf + 1
            loss = (1 - yf) * zf + log_weight * (
                torch.log1p(torch.exp(-torch.abs(zf)))
                + torch.clamp(-zf, min=0))
        if weight is not None:
            loss = loss * rest[i]
        return _reduce(loss, reduction)

    args = [logit, label] + [t for t in (pos_weight, weight)
                             if t is not None]
    return _dispatch("sigmoid_cross_entropy_with_logits", f, *args)


def kl_div(input, label, reduction="mean", name=None):
    def f(logp, y):
        yf = y.float()
        loss = torch.where(
            yf > 0, yf * (torch.log(torch.clamp(yf, min=1e-30)) - logp),
            torch.zeros_like(yf))
        if reduction == "batchmean":
            return torch.sum(loss) / logp.shape[0]
        return _reduce(loss, reduction)

    return _dispatch("kldiv_loss", f, input, label)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _dispatch(
        "margin_ranking_loss",
        lambda a, b, y: _reduce(torch.clamp(-y * (a - b) + margin, min=0.0),
                                reduction),
        input, other, label)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _dispatch(
        "hinge_embedding_loss",
        lambda a, y: _reduce(
            torch.where(y == 1, a, torch.clamp(margin - a, min=0.0)),
            reduction),
        input, label)


def _cosine_similarity(a, b, axis=1, eps=1e-8):
    dot = torch.sum(a * b, dim=axis)
    na = torch.sqrt(torch.sum(a * a, dim=axis))
    nb = torch.sqrt(torch.sum(b * b, dim=axis))
    return dot / torch.clamp(na * nb, min=eps)


def cosine_embedding_loss(input1, input2, label, margin=0,
                          reduction="mean", name=None):
    def f(a, b, y):
        s = _cosine_similarity(a, b)
        return _reduce(torch.where(y == 1, 1 - s,
                                   torch.clamp(s - margin, min=0.0)),
                       reduction)

    return _dispatch("cosine_embedding_loss", f, input1, input2, label)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def f(a, pos, neg):
        def dist(u, v):
            return torch.sum(torch.abs(u - v + epsilon) ** p,
                             dim=-1) ** (1.0 / p)

        dp = dist(a, pos)
        dn = dist(a, neg)
        if swap:
            dn = torch.minimum(dn, dist(pos, neg))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)

    return _dispatch("triplet_margin_loss", f, input, positive, negative)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    def f(a, pos, lab):
        sim = torch.matmul(a, pos.t())
        lab2 = lab.reshape(-1, 1)
        target = (lab2 == lab2.t()).float()
        target = target / torch.sum(target, dim=1, keepdim=True)
        logp = torch.log_softmax(sim, dim=1)
        xent = -torch.mean(torch.sum(target * logp, dim=1))
        reg = l2_reg * (torch.mean(torch.sum(a * a, dim=1))
                        + torch.mean(torch.sum(pos * pos, dim=1))) * 0.25 * 2
        return xent + reg

    return _dispatch("npair_loss", f, anchor, positive, labels)


def log_loss(input, label, epsilon=0.0001, name=None):
    return _dispatch(
        "log_loss",
        lambda p, y: -y * torch.log(p + epsilon)
        - (1 - y) * torch.log(1 - p + epsilon),
        input, label)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the forward recursion in log space: ``log_probs`` ``[T, N,
    C]`` raw logits (log-softmaxed here), ``labels`` ``[N, S]``; the
    extended sequence ``blank, l1, blank, ..., blank`` of ``2S + 1``
    states, each sample read at its ``input_lengths - 1``.  ``"mean"``
    averages the per-sample losses divided by their label lengths."""
    NEG = -1e30

    def f(lp, lab, in_len, lab_len):
        lp = torch.log_softmax(lp.float(), dim=-1)
        T, N, C = lp.shape
        S = lab.shape[1]
        dev = lp.device
        ext = torch.full((N, 2 * S + 1), blank, dtype=torch.long,
                         device=dev)
        ext[:, 1::2] = lab.long()
        ext_len = 2 * lab_len.long() + 1
        skip_ok = torch.zeros((N, 2 * S + 1), dtype=torch.bool, device=dev)
        skip_ok[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
        rows = torch.arange(N, device=dev)
        alpha = torch.full((N, 2 * S + 1), NEG, device=dev)
        alpha[:, 0] = lp[0, rows, ext[:, 0]]
        alpha[:, 1] = torch.where(lab_len > 0, lp[0, rows, ext[:, 1]],
                                  torch.full_like(alpha[:, 1], NEG))
        traj = [alpha]
        neg1 = torch.full((N, 1), NEG, device=dev)
        neg2 = torch.full((N, 2), NEG, device=dev)
        for t in range(1, T):
            shift1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
            shift2 = torch.cat([neg2, alpha[:, :-2]], dim=1)
            shift2 = torch.where(skip_ok, shift2, torch.full_like(shift2,
                                                                  NEG))
            merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
            alpha = merged + torch.gather(lp[t], 1, ext)
            traj.append(alpha)
        traj = torch.stack(traj)                       # [T, N, 2S+1]
        tidx = torch.clamp(in_len.long() - 1, 0, T - 1)
        final = traj[tidx, rows]                       # [N, 2S+1]
        last = torch.gather(final, 1, (ext_len - 1)[:, None]).squeeze(1)
        prev = torch.gather(final, 1, torch.clamp(ext_len - 2, min=0)
                            [:, None]).squeeze(1)
        ll = torch.logaddexp(last, torch.where(ext_len >= 2, prev,
                                               torch.full_like(prev, NEG)))
        loss = -ll
        if reduction == "mean":
            return torch.mean(loss / torch.clamp(lab_len.float(), min=1.0))
        return _reduce(loss, reduction)

    return _dispatch("warpctc", f, log_probs, labels, input_lengths,
                     label_lengths)


def dice_loss(input, label, epsilon=1e-05, name=None):
    def f(p, y):
        yf = torch.nn.functional.one_hot(y.squeeze(-1).long(),
                                         p.shape[-1]).to(p.dtype)
        red = tuple(range(1, p.dim()))
        inter = torch.sum(p * yf, dim=red)
        union = torch.sum(p, dim=red) + torch.sum(yf, dim=red)
        return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))

    return _dispatch("dice_loss", f, input, label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def f(z, y, *maybe_n):
        p = torch.sigmoid(z.float())
        yf = y.float()
        ce = torch.clamp(z, min=0) - z * yf \
            + torch.log1p(torch.exp(-torch.abs(z)))
        p_t = p * yf + (1 - p) * (1 - yf)
        a_t = alpha * yf + (1 - alpha) * (1 - yf)
        loss = a_t * ((1 - p_t) ** gamma) * ce
        if maybe_n:
            loss = loss / maybe_n[0]
        return _reduce(loss, reduction)

    args = [logit, label] + ([] if normalizer is None else [normalizer])
    return _dispatch("sigmoid_focal_loss", f, *args)
