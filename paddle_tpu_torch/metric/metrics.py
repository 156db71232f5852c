"""Metrics — twin of ``paddle_tpu/metric/metrics.py`` (``Accuracy``
top-k, ``Precision``, ``Recall``, ``Auc`` and ``accuracy``).

``Accuracy.compute`` ranks on the prediction's device (``torch.topk``;
the JAX package sorts on the host, ``np.argsort(-pred)``, which agrees
wherever the top-k scores are distinct), so a GPT's ``[B, S, vocab]``
logits never travel to the host: ``update`` reads back the k sums only.
As in the JAX package, ``update`` counts the first axis as the number
of samples, so token accuracy over ``[B, S]`` labels is correct tokens
per sequence.  ``Precision``, ``Recall`` and ``Auc`` count on the host
in numpy."""
from __future__ import annotations

import numpy as np
import torch

from ..tensor import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def _torch(x, device=None):
    if isinstance(x, Tensor):
        return x._value.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(np.asarray(x), device=device)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name or "acc"
        self.maxk = max(self.topk)
        self.reset()

    def compute(self, pred, label, *args):
        """``[..., maxk]`` f32: 1 where the i-th ranked class is the
        label (a ``[..., 1]`` label is squeezed, a one-hot one argmaxed)."""
        p = _torch(pred)
        lab = _torch(label, p.device)
        idx = torch.topk(p, self.maxk, dim=-1).indices
        if lab.dim() == p.dim() and lab.shape[-1] == 1:
            lab = lab.squeeze(-1)
        elif lab.dim() == p.dim():  # one-hot
            lab = torch.argmax(lab, dim=-1)
        return Tensor((idx == lab[..., None].to(idx.dtype)).float())

    def update(self, correct, *args):
        c = _torch(correct)
        num = c.shape[0] if c.dim() > 0 else 1
        sums = _np(torch.stack([c[..., :k].sum() for k in self.topk]))
        accs = []
        for i, corr_k in enumerate(sums):
            self.total[i] += corr_k
            self.count[i] += num
            accs.append(corr_k / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        lab = _np(labels).reshape(-1)
        bins = (p.reshape(-1) * self.num_thresholds).astype(np.int64)
        bins = np.clip(bins, 0, self.num_thresholds)
        for b, y in zip(bins, lab):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            pos = self._stat_pos[i]
            neg = self._stat_neg[i]
            auc += neg * (tot_pos + pos / 2.0)
            tot_pos += pos
            tot_neg += neg
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the top ``k`` scores, a
    0-d f32 Tensor (dispatched as "accuracy")."""
    from ..ops._helpers import to_tensor_like
    from ..ops.dispatch import apply

    def f(p, lab):
        idx = torch.topk(p, k, dim=-1).indices
        corr = torch.any(idx == lab.reshape(-1, 1).to(idx.dtype), dim=1)
        return torch.mean(corr.float())

    return apply("accuracy", f, to_tensor_like(input), to_tensor_like(label))
