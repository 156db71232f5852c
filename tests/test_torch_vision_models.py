"""paddle_tpu_torch's vision models against the JAX package on shared
weights, buffers included, and ``Model.fit`` of a batch-norm network
against the JAX package's ``hapi``.

- ResNet-18 at 64×64, B 4, NCHW and NHWC: one training step (the
  port's dygraph loop, ``loss.backward(); opt.step()``, against the JAX
  package's ``bench.py`` form — ``functional_call`` under
  ``jax.value_and_grad``, then ``Momentum.fused_step``): the loss, every
  parameter after the step and every running statistic; then the eval
  forward on the new statistics.  Again with ``remat=True`` (the port's
  recompute must update the statistics once: they equal the
  non-remat run's).  ResNet-50's forward in both layouts.  (At 32×32,
  B 2 the last stage's batch norms normalize 2 values a channel, which
  is ill-conditioned: the two packages' outputs part by 2e-2 from f32
  rounding alone.  At 64×64, B 4 each normalizes 16 values.)
- VGG-11 with batch norm (no classifier) and MobileNet V1 / V2 at
  ``scale=0.25``: forward in training mode (the batch statistics and
  the updated buffers) and in eval mode.
- ``Model.fit`` of a small conv + batch norm + pool + linear network
  (2 epochs of 4 batches, ``Momentum``) with ``accelerate`` True and
  False against the JAX package's ``accelerate=False``: per-step losses,
  the weights and buffers after it, ``evaluate`` on the running
  statistics.

Tolerances (f32, TF32 off): forward 1e-4 absolute and relative through
the deep stacks (rounding compounds over 20 conv + batch norm layers);
ResNet-50's forward 2e-3 absolute and 1e-3 relative: on these inputs
the JAX package's own output is 8.6e-4 from a float64 run of the port
on the same weights, the port's 3.6e-4 (each first-step batch norm
takes its variance as E[x²] - E[x]² around a zero pivot, in f32, and
the two backends sum it in another order), and its running statistics
a tenth of that; the loss 1e-5; each parameter after the step within 1e-4 of
``lr · max|grad|`` around its value (the gradients themselves agree to
rounding); the running statistics 1e-5 (their batch part is a tenth of
the batch statistic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit.functional import functional_call as jax_call
from paddle_tpu.jit.functional import get_state as jax_state
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.vision import models as jmodels
import paddle_tpu.io as jio
import paddle_tpu_torch as pt
import paddle_tpu_torch.io as tio
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import state_from_numpy
from paddle_tpu_torch.vision import models as tmodels
from torch_layer_parity import one_torch_thread_on_the_cpu

DEEP = dict(rtol=1e-4, atol=1e-4)
DEEP50 = dict(rtol=1e-3, atol=2e-3)
LR, MOMENTUM = 0.1, 0.9


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


def _carry(jmodel, tmodel):
    """Copy the JAX model's parameters and buffers into the port's (the
    ``state_dict`` names equal, in order)."""
    state = {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}
    assert list(state) == list(tmodel.state_dict())
    missing, unexpected = tmodel.set_state_dict(state_from_numpy(state,
                                                                 "cpu"))
    assert missing == [] and unexpected == []


def _pair(name, seed=0, **kw):
    paddle.seed(seed)
    jm = getattr(jmodels, name)(**kw)
    tm = getattr(tmodels, name)(**kw)
    _carry(jm, tm)
    return jm, tm


def _images(fmt, n=4, size=64, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3, size, size).astype(np.float32)
    y = rng.randint(0, 10, (n,)).astype(np.int64)
    return (x.transpose(0, 2, 3, 1).copy() if fmt == "NHWC" else x), y


def _jax_bench_step(jm, x, y):
    """One ``bench.py``-form step of the JAX model, f32: (loss, params,
    buffers, grads)."""
    params, buffers = jax_state(jm)
    opt = jopt.Momentum(LR, MOMENTUM, parameters=jm.parameters())
    loss_fn = jnn.CrossEntropyLoss()

    def loss_of(p):
        out, new_bufs = jax_call(jm, p, buffers, (jnp.asarray(x),),
                                 training=True)
        loss = loss_fn(JTensor(out), JTensor(jnp.asarray(y)))
        return loss._value.astype(jnp.float32), new_bufs

    (loss, new_bufs), grads = jax.value_and_grad(loss_of, has_aux=True)(
        params)
    new_params, _ = opt.fused_step(params, grads, opt.init_opt_state(params),
                                   jnp.asarray(1, jnp.int32))
    return float(loss), new_params, new_bufs, grads


def _port_step(tm, x, y):
    """One dygraph step of the port's model: the loss."""
    opt = topt.Momentum(LR, MOMENTUM, parameters=tm.parameters())
    tm.train()
    loss = tnn.CrossEntropyLoss()(tm(pt.to_tensor(x)), pt.to_tensor(y))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss)


def _check_step(jm, tm, x, y):
    jloss, jparams, jbufs, jgrads = _jax_bench_step(jm, x, y)
    tloss = _port_step(tm, x, y)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    tstate = tm.state_dict()
    for name, want in jparams.items():
        scale = LR * float(np.abs(np.asarray(jgrads[name])).max())
        np.testing.assert_allclose(tstate[name].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4 * max(scale, 1e-3),
                                   err_msg=name)
    for name, want in jbufs.items():
        np.testing.assert_allclose(tstate[name].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    return jparams, jbufs


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet18_step_matches_jax(fmt, remat):
    """One Momentum step; with remat the running statistics must move
    once (equal to the JAX package's single update), then the eval
    forward on them."""
    jm, tm = _pair("resnet18", num_classes=10, data_format=fmt)
    if remat:
        tm = tmodels.resnet18(num_classes=10, data_format=fmt, remat=True)
        _carry(jm, tm)
    x, y = _images(fmt)
    jparams, jbufs = _check_step(jm, tm, x, y)
    # the JAX model's own tensors are untouched by the functional step:
    # write the new state in before comparing the eval forward
    for name, p in jm.named_parameters():
        p._value = jparams[name]
    for name, b in jm.named_buffers():
        b._value = jbufs[name]
    jm.eval()
    tm.eval()
    xe, _ = _images(fmt, seed=2)
    np.testing.assert_allclose(tm(pt.to_tensor(xe)).numpy(),
                               np.asarray(jm(paddle.to_tensor(xe))._value),
                               **DEEP)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet50_forward_matches_jax(fmt):
    jm, tm = _pair("resnet50", num_classes=10, data_format=fmt)
    x, _ = _images(fmt)
    np.testing.assert_allclose(tm(pt.to_tensor(x)).numpy(),
                               np.asarray(jm(paddle.to_tensor(x))._value),
                               **DEEP50)
    # a tenth of each batch statistic: a tenth of the forward's spread
    for (name, jb), (_, tb) in zip(jm.named_buffers(), tm.named_buffers()):
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb._value),
                                   rtol=1e-3, atol=2e-4, err_msg=name)


def test_remat_recompute_restores_amp_and_buffers():
    """A remat block's backward under ``auto_cast``: the recompute runs
    in bf16 like the first run (else the checkpoint's metadata check
    fails), and the statistics equal the non-remat model's after it."""
    from paddle_tpu_torch import amp

    pt.seed(0)
    plain = tmodels.resnet18(num_classes=10)
    pt.seed(0)
    remat = tmodels.resnet18(num_classes=10, remat=True)
    x, y = _images("NCHW")
    grads = []
    for model in (plain, remat):
        with amp.auto_cast(dtype="bfloat16"):
            out = model(pt.to_tensor(x))
        tnn.CrossEntropyLoss()(out, pt.to_tensor(y)).backward()
        grads.append(model.conv1.weight.grad.numpy())
    for (name, a), (_, b) in zip(plain.named_buffers(),
                                 remat.named_buffers()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-2, atol=1e-3)


MODELS = {
    "vgg11_bn": ("vgg11", dict(batch_norm=True, num_classes=0)),
    "mobilenet_v1": ("mobilenet_v1", dict(scale=0.25, num_classes=10)),
    "mobilenet_v2": ("mobilenet_v2", dict(scale=0.25, num_classes=0)),
}


@pytest.mark.parametrize("case", sorted(MODELS))
def test_vgg_and_mobilenet_forward_match_jax(case):
    name, kw = MODELS[case]
    jm, tm = _pair(name, **kw)
    x, _ = _images("NCHW")
    np.testing.assert_allclose(tm(pt.to_tensor(x)).numpy(),
                               np.asarray(jm(paddle.to_tensor(x))._value),
                               **DEEP)
    for (bn, jb), (_, tb) in zip(jm.named_buffers(), tm.named_buffers()):
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb._value),
                                   rtol=1e-5, atol=1e-5, err_msg=bn)
    jm.eval()
    tm.eval()
    np.testing.assert_allclose(tm(pt.to_tensor(x)).numpy(),
                               np.asarray(jm(paddle.to_tensor(x))._value),
                               **DEEP)


def test_mobilenet_v2_classifier_eval_matches_jax():
    jm, tm = _pair("mobilenet_v2", scale=0.25, num_classes=10)
    jm.eval()
    tm.eval()
    x, _ = _images("NCHW")
    np.testing.assert_allclose(tm(pt.to_tensor(x)).numpy(),
                               np.asarray(jm(paddle.to_tensor(x))._value),
                               **DEEP)


# --- Model.fit of a batch-norm network ------------------------------------
def _bn_net(nn):
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 8, 3, padding=1)
            self.bn = nn.BatchNorm2D(8, act="relu")
            self.pool = nn.AdaptiveAvgPool2D(1)
            self.fc = nn.Linear(8, 4)

        def forward(self, x):
            from_pool = self.pool(self.bn(self.conv(x)))
            return self.fc(from_pool.reshape([x.shape[0], 8]))

    return Net()


def _fit(pkg, io, nn, opt_mod, state, accelerate, x, y, **fit_kw):
    paddle.seed(0)
    pt.seed(0)
    net = _bn_net(nn)
    if state is None:
        state = {k: np.asarray(v.numpy()) for k, v in
                 net.state_dict().items()}
    else:
        net.set_state_dict(state_from_numpy(state, "cpu")
                           if pkg is pt else state)
    opt = opt_mod.Momentum(0.05, 0.9, parameters=net.parameters())
    model = pkg.Model(net)
    model.prepare(opt, nn.CrossEntropyLoss(), accelerate=accelerate)
    losses = []

    class Rec(pkg.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    data = io.TensorDataset([x, y])
    model.fit(io.DataLoader(data, batch_size=4, shuffle=False), epochs=2,
              verbose=0, callbacks=[Rec()], **fit_kw)
    out = {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}
    ev = model.evaluate(io.DataLoader(data, batch_size=8), verbose=0)
    return state, losses, out, ev["loss"]


def _bn_data():
    rng = np.random.RandomState(5)
    return (rng.randn(16, 3, 6, 6).astype(np.float32),
            rng.randint(0, 4, (16,)).astype(np.int64))


def test_fit_of_a_batch_norm_network_matches_jax_hapi():
    x, y = _bn_data()
    state, jlosses, jout, jeval = _fit(paddle, jio, jnn, jopt, None, False,
                                       x, y)
    for accelerate in (True, False):
        _, tlosses, tout, teval = _fit(pt, tio, tnn, topt, state,
                                       accelerate, x, y)
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
        assert list(tout) == list(jout)
        for name in jout:
            np.testing.assert_allclose(tout[name], jout[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        np.testing.assert_allclose(teval, jeval, rtol=1e-5)
    assert not np.allclose(tout["bn._mean"], 0.0)


@pytest.mark.parametrize("accelerate", [True, False],
                         ids=["graphed", "eager"])
def test_checkpointed_fit_restores_the_buffers_in_place(accelerate,
                                                        tmp_path):
    """A fit of the batch-norm network checkpointed every 2 steps and
    killed in step 4, resumed by a fresh Model: losses from step 3 on,
    weights and running statistics equal the uninterrupted run's bit for
    bit (the checkpoint carries the buffers and the restore copies them
    in place)."""
    from paddle_tpu_torch.framework.errors import FatalError
    from paddle_tpu_torch.testing import chaos

    x, y = _bn_data()
    state, want_l, want, _ = _fit(pt, tio, tnn, topt, None, accelerate,
                                  x, y)
    d = str(tmp_path / "ck")
    with chaos.running(chaos.ChaosPlan([chaos.Fault("train.step", 4,
                                                    chaos.KILL)])):
        with pytest.raises(FatalError):
            _fit(pt, tio, tnn, topt, state, accelerate, x, y,
                 checkpoint_dir=d, checkpoint_interval=2,
                 checkpoint_async=False)
    _, got_l, got, _ = _fit(pt, tio, tnn, topt, state, accelerate, x, y,
                            checkpoint_dir=d, checkpoint_interval=2,
                            resume=True)
    assert got_l == want_l[2:]
    assert list(got) == list(want) and "bn._variance" in got
    for k in want:
        assert np.array_equal(got[k], want[k]), k
