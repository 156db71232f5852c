"""LeNet eager training through paddle_tpu_torch's dygraph core vs the JAX
package (``BASELINE.json`` config 1, ``tests/test_end_to_end.py:13``).

paddle_tpu's ``LeNet()`` built under ``paddle.seed(0)`` gives the
weights; they go into the port's ``LeNet`` through ``state_from_numpy``
and ``set_state_dict``.  The batches are the JAX MNIST's own arrays (the
synthetic stand-in, which the port's MNIST reproduces) in order.  On the
CPU, in f32:

- ``state_dict`` keys and shapes equal paddle_tpu's;
- the logits of one batch of 32 within atol 1e-5 (two convolutions and
  three matmuls over the same f32 values, summed in other orders);
- 20 ``Adam(1e-3)`` steps of ``F.cross_entropy`` on in-order batches of
  32: every loss within rtol 1e-4 (the gradients differ by rounding
  only; Adam's normalized step turns that into weight differences of a
  few ulps of ``lr`` per step);
- a port-only twin of ``test_lenet_eager_training_reduces_loss``.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.vision.datasets import MNIST as JaxMNIST
from paddle_tpu.vision.models import LeNet as JaxLeNet

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.nn.layer import state_from_numpy
from paddle_tpu_torch.vision.datasets import MNIST
from paddle_tpu_torch.vision.models import LeNet

BATCH, STEPS = 32, 20


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def _batch(ds, i):
    items = [ds[j] for j in range(i * BATCH, (i + 1) * BATCH)]
    return (np.stack([x for x, _ in items]),
            np.stack([y for _, y in items]))


@pytest.fixture(scope="module")
def jax_run():
    """paddle_tpu's LeNet weights, the first batch's logits and 20 Adam
    losses on in-order batches."""
    paddle.seed(0)
    model = JaxLeNet()
    state = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    ds = JaxMNIST(mode="train")
    batches = [_batch(ds, i) for i in range(STEPS)]
    logits = model(paddle.to_tensor(batches[0][0])).numpy()
    opt = jopt.Adam(learning_rate=1e-3, parameters=model.parameters())
    losses = []
    for x, y in batches:
        loss = JF.cross_entropy(model(paddle.to_tensor(x)),
                                paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return state, batches, logits, losses


def _port_lenet(state):
    model = LeNet()
    assert model.set_state_dict(state_from_numpy(state, "cpu")) == ([], [])
    return model


def test_state_dict_keys_and_shapes_match(jax_run):
    state = jax_run[0]
    pt.seed(0)
    got = LeNet().state_dict()
    assert list(got) == list(state)
    for k, v in got.items():
        assert v.shape == list(state[k].shape), k
        assert v.dtype == torch.float32


def test_state_from_numpy_copies_onto_the_device(jax_run):
    state = jax_run[0]
    tensors = state_from_numpy(state, "cpu")
    assert list(tensors) == list(state)
    for k, t in tensors.items():
        assert t.device.type == "cpu" and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), state[k])
    tensors["fc.2.bias"][0] += 1.0             # a copy, not a view
    assert tensors["fc.2.bias"][0].item() != state["fc.2.bias"][0]


def test_synthetic_mnist_equals_the_jax_package(jax_run):
    jds, ds = JaxMNIST(mode="train"), MNIST(mode="train")
    assert ds.synthetic and len(ds) == len(jds) == 2048
    np.testing.assert_array_equal(ds.images, jds.images)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    for i in (0, 777):
        for a, b in zip(ds[i], jds[i]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    x, y = ds.batch(0, BATCH)
    np.testing.assert_array_equal(x, jax_run[1][0][0])
    np.testing.assert_array_equal(y, jax_run[1][0][1])
    test = MNIST(mode="test")
    assert len(test) == 512
    np.testing.assert_array_equal(test.labels, JaxMNIST(mode="test").labels)


def test_idx_files_read_as_the_jax_reader(tmp_path):
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 5).astype(np.uint8)
    ip, lp = str(tmp_path / "img-idx3-ubyte.gz"), str(tmp_path / "lab")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    ds, jds = MNIST(ip, lp), JaxMNIST(ip, lp)
    assert not ds.synthetic
    np.testing.assert_array_equal(ds.images, jds.images)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    assert MNIST(str(tmp_path / "missing"), lp).synthetic


def test_logits_match(jax_run):
    state, batches, want, _ = jax_run
    model = _port_lenet(state)
    got = model(pt.to_tensor(batches[0][0]))
    assert got.shape == [BATCH, 10]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_adam_losses_match(jax_run):
    state, batches, _, want = jax_run
    model = _port_lenet(state)
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    got = []
    for x, y in batches:
        loss = F.cross_entropy(model(pt.to_tensor(x)), pt.to_tensor(y))
        assert isinstance(loss, pt.Tensor) and loss.shape == []
        loss.backward()
        opt.step()
        opt.clear_grad()
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_lenet_eager_training_reduces_loss():
    """Port-only twin of paddle_tpu's test: seeded LeNet, Adam(1e-3),
    21 shuffled batches of 32 (numpy's permutation: the port has no
    DataLoader yet)."""
    pt.seed(0)
    model = LeNet()
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    ds = MNIST(mode="train")
    order = np.random.RandomState(0).permutation(len(ds))
    losses = []
    for i in range(21):
        idx = order[i * BATCH:(i + 1) * BATCH]
        x = np.stack([ds[j][0] for j in idx])
        y = np.stack([ds[j][1] for j in idx])
        loss = F.cross_entropy(model(pt.to_tensor(x)), pt.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
