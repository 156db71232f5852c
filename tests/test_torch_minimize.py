"""``minimize`` runs the backward exactly while the loss's graph has not
been consumed — the reference's rule (``paddle_tpu/optimizer/
optimizer.py:289-292``, ``paddle_tpu/amp/grad_scaler.py:78-88``),
held against paddle_tpu on the CPU (fault M1, ROADMAP §3).

The case that showed the fault: ``Linear(2, 2, bias_attr=False)`` with
weight ``[[1, 2], [3, 4]]``, ``SGD(0.1)``, ``minimize(sum(lin(x)))`` on
x ``[[1, 0.5]]`` then ``[[-2, 1]]`` and no ``clear_grad``: gradients of
step 1 accumulate into step 2, so ``weight[0, 0]`` is 1.0 after it (and
1.075 through ``GradScaler(init_loss_scaling=4.0)``); a port that
skipped the backward while stale gradients were present gave 0.8 and
0.875.  Weights are compared within 1e-6 (f32 products of a few terms)."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import place

W0 = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
XS = [np.array([[1.0, 0.5]], np.float32), np.array([[-2.0, 1.0]],
                                                    np.float32)]


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def _run(P, mode):
    lin = P.nn.Linear(2, 2, bias_attr=False)
    lin.weight.set_value(W0)
    opt = P.optimizer.SGD(0.1, parameters=lin.parameters())
    scaler = P.amp.GradScaler(init_loss_scaling=4.0)
    for x in XS:
        loss = lin(P.to_tensor(x)).sum()
        if mode == "scaler":
            scaler.minimize(opt, scaler.scale(loss))
        elif mode == "backward_first":
            loss.backward()
            opt.minimize(loss)
        elif mode == "retain_graph":
            loss.backward(retain_graph=True)
            opt.minimize(loss)
        else:
            opt.minimize(loss)
    return np.asarray(lin.weight.numpy())


@pytest.mark.parametrize("mode,w00", [("plain", 1.0), ("scaler", 1.075),
                                      ("backward_first", 1.0),
                                      ("retain_graph", 1.0)])
def test_minimize_accumulates_as_the_reference(mode, w00):
    want, got = _run(jp, mode), _run(pt, mode)
    np.testing.assert_allclose(want[0, 0], w00, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_backward_and_grad_consume_the_graph():
    from paddle_tpu_torch.tensor import graph_consumed

    x = pt.to_tensor(W0, stop_gradient=False)
    loss = (x * x).sum()
    assert not graph_consumed(loss)
    loss.backward(retain_graph=True)
    assert not graph_consumed(loss)
    loss.backward()
    assert graph_consumed(loss)
    other = (x * 3).sum()
    pt.grad(other, x)
    assert graph_consumed(other)
    kept = (x * 3).sum()
    pt.grad(kept, x, retain_graph=True)
    assert not graph_consumed(kept)
    assert graph_consumed(pt.to_tensor(W0))     # no graph at all
