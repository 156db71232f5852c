"""The port's twins of ``tests/test_end_to_end.py`` (the anchors of the
dygraph and declarative slices), held against the JAX package where
both can run the same thing, and the graft entry's BERT encoder
(``__graft_entry__.entry()``: vocab 1024, hidden 256, 4 layers) through
both packages' ``functional_call``.

(The dygraph LeNet against the JAX package's, step by step, is
``tests/test_torch_lenet.py``'s.)  Tolerances: the accelerated and
eager hapi steps and ``to_static`` against eager rtol 1e-6; the BERT encoder's
sequence output rtol 1e-4 / atol 1e-5 (4 layers of f32 matmuls and
layer norms, 256 wide); the GradScaler's values exact (powers of two).
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.jit.functional import functional_call, get_state
from paddle_tpu_torch.nn.layer import state_from_numpy
from paddle_tpu_torch.text.models import BertModel
from paddle_tpu_torch.vision.datasets import MNIST
from paddle_tpu_torch.vision.models import LeNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small ops on one thread: the suite's workers share the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def test_lenet_eager_training_reduces_loss():
    pt.seed(0)
    model = LeNet()
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    loader = DataLoader(MNIST(mode="train"), batch_size=32, shuffle=True,
                        drop_last=True)
    losses = []
    for i, (x, y) in enumerate(loader):
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
        if i >= 20:
            break
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_lenet_hapi_fit():
    from paddle_tpu_torch.metric import Accuracy

    pt.seed(0)
    model = pt.Model(LeNet())
    model.prepare(optimizer.Adam(learning_rate=1e-3,
                                 parameters=model.parameters()),
                  nn.CrossEntropyLoss(), Accuracy())
    model.fit(MNIST(mode="train"), batch_size=64, epochs=1, verbose=0,
              num_iters=15)
    res = model.evaluate(MNIST(mode="test"), batch_size=64, verbose=0,
                         num_iters=5)
    assert "loss" in res and "acc" in res
    assert res["acc"] > 0.15


def test_hapi_predict_and_save_load(tmp_path):
    model = pt.Model(LeNet())
    model.prepare(optimizer.SGD(0.1, parameters=model.parameters()),
                  nn.CrossEntropyLoss())
    test = MNIST(mode="test")
    out = model.predict(test, batch_size=32, stack_outputs=True)
    assert out[0].shape == (len(test), 10)
    path = str(tmp_path / "ckpt" / "model")
    model.save(path)
    model2 = pt.Model(LeNet())
    model2.prepare(optimizer.SGD(0.1, parameters=model2.parameters()),
                   nn.CrossEntropyLoss())
    model2.load(path)
    w1 = model.network.state_dict()["features.0.weight"].numpy()
    w2 = model2.network.state_dict()["features.0.weight"].numpy()
    np.testing.assert_array_equal(w1, w2)


def test_accelerated_train_step_matches_eager():
    rng = np.random.RandomState(3)
    x = rng.randn(64, 10).astype(np.float32)
    y = x @ rng.randn(10, 1).astype(np.float32) \
        + 0.01 * rng.randn(64, 1).astype(np.float32)

    def train(accelerate):
        pt.seed(5)
        net = nn.Linear(10, 1)
        model = pt.Model(net)
        model.prepare(optimizer.SGD(0.1, parameters=net.parameters()),
                      nn.MSELoss(), accelerate=accelerate)
        for _ in range(30):
            model.train_batch([pt.to_tensor(x)], [pt.to_tensor(y)])
        return net.weight.numpy()

    np.testing.assert_allclose(train(True), train(False), rtol=1e-6,
                               atol=1e-7)


def test_save_load_tensor_roundtrip(tmp_path):
    obj = {"a": pt.to_tensor([1.0, 2.0]),
           "nested": {"b": pt.ones([2, 2])}, "scalar": 3}
    p = str(tmp_path / "obj.pd")
    pt.save(obj, p)
    loaded = pt.load(p)
    np.testing.assert_array_equal(loaded["a"].numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(loaded["nested"]["b"].numpy(),
                                  np.ones((2, 2)))
    assert loaded["scalar"] == 3


def test_to_static_linear():
    paddle.seed(0)
    jnet = paddle.nn.Linear(4, 2)
    net = nn.Linear(4, 2)
    net.set_state_dict(state_from_numpy(
        {k: np.asarray(v._value) for k, v in jnet.state_dict().items()},
        "cpu"))
    eager = net(pt.ones([3, 4])).numpy()
    got = pt.jit.to_static(net)(pt.ones([3, 4])).numpy()
    np.testing.assert_allclose(got, eager, rtol=1e-6)
    want = paddle.jit.to_static(jnet)(paddle.ones([3, 4])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_to_static_grads_flow():
    pt.seed(0)
    net = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    ref = [p.numpy().copy() for p in net.parameters()]
    pt.jit.to_static(net)
    net(pt.ones([2, 4])).sum().backward()
    assert all(p.grad is not None for p in net.parameters())
    optimizer.SGD(0.1, parameters=net.parameters()).step()
    assert any(not np.allclose(p.numpy(), r)
               for p, r in zip(net.parameters(), ref))


def test_amp_autocast_bf16():
    with pt.amp.auto_cast(dtype="bfloat16"):
        out = pt.matmul(pt.ones([4, 4]), pt.ones([4, 4]))
    assert out.dtype == pt.bfloat16
    assert pt.matmul(pt.ones([4, 4]), pt.ones([4, 4])).dtype == pt.float32


def test_grad_scaler_fp16_parity():
    p = pt.Parameter(np.array([1.0], np.float32))
    opt = optimizer.SGD(1.0, parameters=[p])
    scaler = pt.amp.GradScaler(init_loss_scaling=8.0)
    scaler.scale((p * 2).sum()).backward()
    np.testing.assert_allclose(p.grad.numpy(), [16.0])   # scaled grad
    scaler.step(opt)
    scaler.update()
    np.testing.assert_allclose(p.numpy(), [-1.0])        # unscaled 2


def test_grad_scaler_skips_on_inf():
    p = pt.Parameter(np.array([1.0], np.float32))
    opt = optimizer.SGD(1.0, parameters=[p])
    scaler = pt.amp.GradScaler(init_loss_scaling=8.0,
                               decr_every_n_nan_or_inf=1)
    p.grad = pt.to_tensor([np.inf])
    scaler.step(opt)
    scaler.update()
    np.testing.assert_allclose(p.numpy(), [1.0])          # step skipped
    assert scaler.get_loss_scaling() == 4.0               # scale halved


def test_graft_entry_bert_encoder_matches_jax():
    """``__graft_entry__.entry()``'s BERT encoder forward through both
    packages' ``functional_call`` on its weights and example ids."""
    sys.path.insert(0, ROOT)
    import __graft_entry__

    fwd, (params, ids) = __graft_entry__.entry()
    want = np.asarray(fwd(params, ids))
    model = BertModel(vocab_size=1024, hidden_size=256, num_hidden_layers=4,
                      num_attention_heads=8, intermediate_size=1024,
                      max_position_embeddings=128)
    state = {k: np.asarray(v) for k, v in params.items()}
    model.set_state_dict(state_from_numpy(state, "cpu"))
    tparams, buffers = get_state(model)
    (seq, pooled), _ = functional_call(
        model, tparams, buffers, (pt.to_tensor(np.asarray(ids)),),
        training=False)
    assert tuple(seq.shape) == want.shape == (2, 64, 256)
    np.testing.assert_allclose(seq.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
