"""fleet.metrics — twin of ``paddle_tpu/distributed/fleet/metrics.py``
(reference fleet/metrics/metric.py): distributed metric reductions over
the trainer group (``fleet.util.all_reduce`` over the gloo backend)."""
from __future__ import annotations

import numpy as np


def _all_reduce(arr, mode="sum"):
    """The reduction over the trainers: the value itself in a world of
    one.  Difference by design: where the JAX package swallows a failed
    reduction and returns the local value, the port raises (several
    trainers without the gloo backend)."""
    from .fleet_base import fleet

    return fleet.util.all_reduce(np.asarray(arr, np.float64), mode)


def sum(input):  # noqa: A001 — reference name
    return _all_reduce(np.asarray(input).sum(), "sum")


def max(input):  # noqa: A001
    return _all_reduce(np.asarray(input).max(), "max")


def min(input):  # noqa: A001
    return _all_reduce(np.asarray(input).min(), "min")


def auc(stat_pos, stat_neg):
    """Global AUC from per-trainer positive/negative threshold stats."""
    pos = _all_reduce(np.asarray(stat_pos, np.float64), "sum")
    neg = _all_reduce(np.asarray(stat_neg, np.float64), "sum")
    pos = np.asarray(pos).reshape(-1)
    neg = np.asarray(neg).reshape(-1)
    tot_pos = new_pos = 0.0
    tot_neg = new_neg = 0.0
    area = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_pos = tot_pos + pos[i]
        new_neg = tot_neg + neg[i]
        area += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
        tot_pos, tot_neg = new_pos, new_neg
    if tot_pos == 0 or tot_neg == 0:
        return 0.5
    return float(area / (tot_pos * tot_neg))


def acc(correct, total):
    c = _all_reduce(np.asarray(correct, np.float64).sum(), "sum")
    t = _all_reduce(np.asarray(total, np.float64).sum(), "sum")
    return float(np.asarray(c) / np.maximum(np.asarray(t), 1.0))


def mae(abserr, total_ins_num):
    e = _all_reduce(np.asarray(abserr, np.float64).sum(), "sum")
    n = _all_reduce(np.asarray(total_ins_num, np.float64).sum(), "sum")
    return float(np.asarray(e) / np.maximum(np.asarray(n), 1.0))


def rmse(sqrerr, total_ins_num):
    e = _all_reduce(np.asarray(sqrerr, np.float64).sum(), "sum")
    n = _all_reduce(np.asarray(total_ins_num, np.float64).sum(), "sum")
    return float(np.sqrt(np.asarray(e) / np.maximum(np.asarray(n), 1.0)))
