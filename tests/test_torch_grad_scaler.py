"""paddle_tpu_torch's ``amp.GradScaler`` / ``AmpScaler`` against the JAX
package's.

- Seeded sequences of finite and infinite gradients (one and two
  optimizers, ``decr_every_n_nan_or_inf`` 1 and 2, ``incr_every_n_steps``
  2 and 3, dynamic and static scaling) drive both packages' scalers in
  lockstep: the scale, the good-step and bad-step counts after every
  ``update()`` and whether each optimizer stepped are equal, and the
  parameters equal bit for bit (SGD on powers of two: exact in f32).
- The twins of ``tests/test_end_to_end.py:138-160`` (the fp16 parity of
  one SGD step, the step skipped on inf) and of the scaler cases of
  ``tests/test_distributed.py`` (explicit ``unscale_`` then ``step``
  does not unscale twice, ``unscale_`` twice and ``step`` twice raise,
  an inf in one optimizer is not erased by another's finite
  ``unscale_``), ``minimize`` with and without a prior backward,
  ``state_dict`` round trips and ``enable=False``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.amp import AmpScaler as JaxAmpScaler
from paddle_tpu.amp import GradScaler as JaxGradScaler

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import AmpScaler, GradScaler
from paddle_tpu_torch.framework import place


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def _pair(n_opts, lr=0.25):
    """``n_opts`` one-parameter SGD optimizers in each package, the
    parameters at 1.0."""
    jps = [paddle.Parameter(np.ones(3, np.float32)) for _ in range(n_opts)]
    tps = [pt.Parameter(np.ones(3, np.float32)) for _ in range(n_opts)]
    jos = [jopt.SGD(lr, parameters=[p]) for p in jps]
    tos = [topt.SGD(lr, parameters=[p]) for p in tps]
    return jps, tps, jos, tos


@pytest.mark.parametrize("cls", ["GradScaler", "AmpScaler"])
@pytest.mark.parametrize("case", [
    dict(seed=0, n_opts=1, decr=1, incr=2, dynamic=True),
    dict(seed=1, n_opts=1, decr=2, incr=3, dynamic=True),
    dict(seed=2, n_opts=2, decr=1, incr=2, dynamic=True),
    dict(seed=3, n_opts=2, decr=2, incr=3, dynamic=False),
], ids=["one", "decr2", "two_opts", "static"])
def test_trajectories_equal_the_jax_scaler(cls, case):
    rng = np.random.RandomState(case["seed"])
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=case["incr"],
              decr_every_n_nan_or_inf=case["decr"],
              use_dynamic_loss_scaling=case["dynamic"])
    js = {"GradScaler": JaxGradScaler, "AmpScaler": JaxAmpScaler}[cls](**kw)
    ts = {"GradScaler": GradScaler, "AmpScaler": AmpScaler}[cls](**kw)
    jps, tps, jos, tos = _pair(case["n_opts"])
    for _ in range(24):
        for jp, tp in zip(jps, tps):
            g = (2.0 ** rng.randint(-2, 3, 3) * ts.get_loss_scaling()
                 ).astype(np.float32)
            if rng.rand() < 0.3:
                g[rng.randint(3)] = rng.choice([np.inf, -np.inf, np.nan])
            jp._grad = paddle.to_tensor(g)
            tp._value.grad = torch.from_numpy(g.copy())
        for jo, to in zip(jos, tos):
            js.step(jo)
            ts.step(to)
        js.update()
        ts.update()
        assert ts.get_loss_scaling() == js.get_loss_scaling()
        assert (ts._good_steps, ts._bad_steps) == (js._good_steps,
                                                   js._bad_steps)
        for jp, tp in zip(jps, tps):
            assert np.asarray(jp._value).tobytes() == \
                tp._value.detach().numpy().tobytes()
    assert ts.state_dict() == js.state_dict()


def test_fp16_parity_one_step():
    p = pt.Parameter(np.array([1.0], np.float32))
    opt = topt.SGD(1.0, parameters=[p])
    scaler = GradScaler(init_loss_scaling=8.0)
    scaled = scaler.scale((p * 2).sum())
    scaled.backward()
    np.testing.assert_allclose(p.grad.numpy(), [16.0])
    scaler.step(opt)
    scaler.update()
    np.testing.assert_allclose(p.numpy(), [-1.0])


def test_skips_on_inf():
    p = pt.Parameter(np.array([1.0], np.float32))
    opt = topt.SGD(1.0, parameters=[p])
    scaler = GradScaler(init_loss_scaling=8.0, decr_every_n_nan_or_inf=1)
    p._value.grad = torch.tensor([np.inf])
    scaler.step(opt)
    scaler.update()
    np.testing.assert_allclose(p.numpy(), [1.0])
    assert scaler.get_loss_scaling() == 4.0


def _linear_pair(lr, seed=0):
    paddle.seed(seed)
    jl = jnn.Linear(4, 4)
    tl = tnn.Linear(4, 4)
    tl.weight._value.data.copy_(torch.from_numpy(np.asarray(
        jl.weight._value).copy()))
    tl.bias._value.data.copy_(torch.from_numpy(np.asarray(
        jl.bias._value).copy()))
    return (jl, jopt.SGD(learning_rate=lr, parameters=jl.parameters()),
            tl, topt.SGD(learning_rate=lr, parameters=tl.parameters()))


def test_explicit_unscale_then_step_unscales_once():
    jl, jo, tl, to = _linear_pair(0.0)
    js, ts = JaxGradScaler(init_loss_scaling=1024.0), \
        GradScaler(init_loss_scaling=1024.0)
    js.scale(jl(paddle.ones([2, 4])).sum()).backward()
    ts.scale(tl(pt.to_tensor(np.ones((2, 4), np.float32))).sum()).backward()
    js.unscale_(jo)
    ts.unscale_(to)
    g0 = tl.weight.grad.numpy()
    ts.step(to)
    js.step(jo)
    ts.update()
    js.update()
    np.testing.assert_allclose(tl.weight.grad.numpy(), g0)
    np.testing.assert_allclose(g0, np.asarray(jl.weight._grad._value),
                               rtol=1e-6)


def test_unscale_twice_and_step_twice_raise():
    _, _, tl, to = _linear_pair(0.1)
    scaler = GradScaler()
    scaler.scale(tl(pt.to_tensor(np.ones((1, 4), np.float32))).sum()
                 ).backward()
    scaler.unscale_(to)
    with pytest.raises(RuntimeError):
        scaler.unscale_(to)
    scaler.step(to)
    with pytest.raises(RuntimeError):
        scaler.step(to)
    scaler.update()
    scaler.unscale_(to)          # a new cycle after update()


def test_inf_in_one_optimizer_is_not_erased():
    l1, l2 = tnn.Linear(2, 2), tnn.Linear(2, 2)
    o1 = topt.SGD(learning_rate=0.1, parameters=l1.parameters())
    o2 = topt.SGD(learning_rate=0.1, parameters=l2.parameters())
    scaler = GradScaler(init_loss_scaling=4.0)
    x = pt.to_tensor(np.ones((1, 2), np.float32))
    (scaler.scale(l1(x).sum()) + scaler.scale(l2(x).sum())).backward()
    l1.weight._value.grad = torch.full((2, 2), float("inf"))
    w1 = l1.weight.numpy()
    w2 = l2.weight.numpy()
    scaler.unscale_(o1)
    scaler.unscale_(o2)
    scaler.step(o1)
    scaler.step(o2)
    scaler.update()
    np.testing.assert_array_equal(l1.weight.numpy(), w1)
    assert not np.array_equal(l2.weight.numpy(), w2)
    assert scaler.get_loss_scaling() == 2.0


@pytest.mark.parametrize("backward_first", [False, True])
def test_minimize_runs_backward_only_when_needed(backward_first):
    jl, jo, tl, to = _linear_pair(0.5, seed=3)
    js, ts = JaxGradScaler(init_loss_scaling=64.0), \
        GradScaler(init_loss_scaling=64.0)
    jscaled = js.scale(jl(paddle.ones([2, 4])).sum())
    tscaled = ts.scale(tl(pt.to_tensor(np.ones((2, 4), np.float32))).sum())
    if backward_first:
        jscaled.backward()
        tscaled.backward()
    js.minimize(jo, jscaled)
    ts.minimize(to, tscaled)
    np.testing.assert_allclose(tl.weight.numpy(),
                               np.asarray(jl.weight._value), rtol=1e-6)
    assert ts.get_loss_scaling() == js.get_loss_scaling()


def test_state_dict_and_disabled():
    ts = GradScaler(init_loss_scaling=32.0, incr_every_n_steps=1)
    ts.update()
    assert ts.state_dict() == {"scale": 64.0, "incr_ratio": 2.0,
                               "decr_ratio": 0.5, "good_steps": 0,
                               "bad_steps": 0}
    other = GradScaler()
    other.load_state_dict(ts.state_dict())
    assert other.get_loss_scaling() == 64.0
    off = GradScaler(enable=False)
    p = pt.Parameter(np.array([1.0], np.float32))
    opt = topt.SGD(1.0, parameters=[p])
    loss = (p * 3).sum()
    assert off.scale(loss) is loss
    loss.backward()
    off.unscale_(opt)
    off.step(opt)
    off.update()
    np.testing.assert_allclose(p.numpy(), [-2.0])
    assert off.get_loss_scaling() == 2.0 ** 15 and not off.is_enable()
    assert ts.get_incr_ratio() == 2.0 and ts.get_decr_ratio() == 0.5
