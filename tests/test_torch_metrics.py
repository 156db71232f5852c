"""paddle_tpu_torch.metric against the JAX package's.

Seeded scores and labels go through both packages' metrics over three
batches: ``Accuracy`` (top-1 and top-(1, 3), ``[N, 1]``, ``[N]`` and
one-hot labels, and token accuracy over ``[B, S, V]`` logits),
``Precision``, ``Recall``, ``Auc`` and ``accuracy``.  The per-batch
values and the accumulated ones must be equal (to 1e-7: the same counts
divided alike; the port ranks with ``torch.topk`` on the scores'
device, the JAX package with ``np.argsort`` on the host, which agree on
distinct scores, as these are)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as jm
from paddle_tpu_torch import metric as tm

TOL = 1e-7


def _label(rng, kind, n, c):
    lab = rng.randint(0, c, (n,)).astype(np.int64)
    if kind == "n1":
        return lab[:, None]
    if kind == "onehot":
        return np.eye(c, dtype=np.float32)[lab]
    return lab


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("topk", [1, (1, 3)], ids=["top1", "top1_3"])
@pytest.mark.parametrize("kind", ["n1", "n", "onehot", "tokens"])
def test_accuracy_matches_jax(topk, kind):
    rng = np.random.RandomState(5)
    j, t = jm.Accuracy(topk=topk), tm.Accuracy(topk=topk)
    assert t.name() == j.name()
    for _ in range(3):
        if kind == "tokens":
            pred = rng.randn(2, 6, 9).astype(np.float32)
            lab = rng.randint(0, 9, (2, 6)).astype(np.int64)
        else:
            pred = rng.randn(16, 7).astype(np.float32)
            lab = _label(rng, kind, 16, 7)
        jc = j.compute(paddle.to_tensor(pred), paddle.to_tensor(lab))
        tc = t.compute(torch.from_numpy(pred), torch.from_numpy(lab))
        np.testing.assert_array_equal(tc.numpy(), jc.numpy())
        _close(t.update(tc), j.update(jc))
    _close(t.accumulate(), j.accumulate())
    t.reset()
    assert t.count == [0] * len(t.topk)


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_jax(name):
    rng = np.random.RandomState(6)
    j, t = getattr(jm, name)(), getattr(tm, name)()
    for i in range(3):
        scores = rng.rand(32).astype(np.float32)
        if name == "Auc" and i == 1:
            scores = np.stack([1 - scores, scores], axis=1)
        lab = rng.randint(0, 2, (32, 1)).astype(np.int64)
        j.update(paddle.to_tensor(scores), paddle.to_tensor(lab))
        t.update(torch.from_numpy(scores), torch.from_numpy(lab))
    assert t.name() == j.name()
    _close(t.accumulate(), j.accumulate())
    assert 0.0 < t.accumulate() < 1.0


@pytest.mark.parametrize("k", [1, 2, 4])
def test_accuracy_function_matches_jax(k):
    rng = np.random.RandomState(7)
    pred = rng.randn(20, 6).astype(np.float32)
    lab = rng.randint(0, 6, (20, 1)).astype(np.int64)
    want = jm.accuracy(paddle.to_tensor(pred), paddle.to_tensor(lab), k=k)
    got = tm.accuracy(torch.from_numpy(pred), torch.from_numpy(lab), k=k)
    assert got.dtype == torch.float32
    _close(got.numpy(), want.numpy())
