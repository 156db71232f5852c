"""paddle_tpu_torch's hapi ``StaticGraphAdapter`` against paddle_tpu's.

The twin of ``tests/test_hapi_static.py``: with static mode on,
``Model.prepare`` selects the adapter and ``fit`` / ``evaluate`` /
``predict`` run recorded Programs through ``static.Executor``.  LeNet on
a toy set, the JAX package's weights carried across by ``state_dict``
name: ``train_batch`` losses (Adam) and ``evaluate`` / ``predict`` equal
the JAX package's static path within rtol 1e-4 (the convolutions'
rounding, through Adam's normalized step, as ``tests/test_torch_lenet.
py`` holds LeNet), and the port's static path equals its own dygraph
path within rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import hapi as jhapi
from paddle_tpu import optimizer as jopt
from paddle_tpu.io.dataset import Dataset as JDataset
from paddle_tpu.jit import InputSpec as JSpec
from paddle_tpu.metric import Accuracy as JAccuracy
from paddle_tpu.vision.models import LeNet as JLeNet

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import hapi as thapi
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.io.dataset import Dataset as TDataset
from paddle_tpu_torch.jit import InputSpec as TSpec
from paddle_tpu_torch.metric import Accuracy as TAccuracy
from paddle_tpu_torch.nn.layer import state_from_numpy
from paddle_tpu_torch.vision.models import LeNet as TLeNet

PKG = {"jax": (paddle, JF, jhapi, jopt, JDataset, JSpec, JAccuracy, JLeNet),
       "torch": (pt, TF, thapi, topt, TDataset, TSpec, TAccuracy, TLeNet)}


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


def _toy(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 1, 28, 28).astype(np.float32)
    w = rng.randn(28 * 28).astype(np.float32)
    score = x.reshape(n, -1) @ w
    y = np.stack([score > 0, score <= 0], 1).argmax(1).astype(
        np.int64)[:, None]
    return x, y


def _ds(pkg, n=64, seed=0):
    base = PKG[pkg][4]
    x, y = _toy(n, seed)

    class Toy(base):
        def __getitem__(self, i):
            return x[i], y[i]

        def __len__(self):
            return n

    return Toy()


def _models(opt_name="Adam", lr=1e-3, metrics=True, static=True):
    """Both packages' LeNet Models, prepared (static mode on while they
    are); the port's weights are the JAX package's."""
    out = {}
    paddle.seed(0)
    for pkg in ("jax", "torch"):
        api, F, hapi, O, _, Spec, Acc, LeNet = PKG[pkg]
        if static:
            api.enable_static()
        try:
            net = LeNet()
            if pkg == "torch":
                net.set_state_dict(state_from_numpy(
                    {k: np.asarray(v._value) for k, v in
                     out["jax"].network.state_dict().items()}, "cpu"))
            model = hapi.Model(
                net, [Spec([None, 1, 28, 28], "float32", name="img")],
                [Spec([None, 1], "int64", name="lbl")])
            model.prepare(getattr(O, opt_name)(lr,
                                               parameters=net.parameters()),
                          loss=F.cross_entropy,
                          metrics=Acc() if metrics else None)
        finally:
            if static:
                api.disable_static()
        out[pkg] = model
    return out


class TestStaticAdapter:
    def test_train_batch_matches_jax(self):
        models = _models()
        assert models["torch"]._adapter is not None
        x, y = _toy(64)
        losses = {}
        for pkg, m in models.items():
            api = PKG[pkg][0]
            api.enable_static()
            try:
                losses[pkg] = [m.train_batch([x[i:i + 16]],
                                             [y[i:i + 16]])[0]
                               for i in range(0, 48, 16)]
            finally:
                api.disable_static()
        np.testing.assert_allclose(losses["torch"], losses["jax"],
                                   rtol=1e-4)

    def test_fit_trains_lenet(self):
        m = _models(metrics=False)["torch"]
        x, y = _toy(64)
        pt.enable_static()
        try:
            first = m.train_batch([x[:16]], [y[:16]])[0]
            m.fit(_ds("torch"), batch_size=16, epochs=3, verbose=0)
            last = m.train_batch([x[:16]], [y[:16]])[0]
        finally:
            pt.disable_static()
        assert last < first * 0.5, (first, last)

    def test_evaluate_and_predict_match_jax(self):
        models = _models("SGD", 0.01)
        got = {}
        for pkg, m in models.items():
            api = PKG[pkg][0]
            api.enable_static()
            try:
                logs = m.evaluate(_ds(pkg, 32, 2), batch_size=16, verbose=0)
                preds = m.predict(_ds(pkg, 32, 2), batch_size=16)
            finally:
                api.disable_static()
            assert "loss" in logs and "acc" in logs
            got[pkg] = (np.asarray(logs["loss"]).ravel()[0],
                        float(np.asarray(logs["acc"]).ravel()[0]),
                        np.concatenate(preds[0], axis=0))
        assert got["torch"][2].shape == (32, 10)
        np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-5)
        assert got["torch"][1] == got["jax"][1]
        np.testing.assert_allclose(got["torch"][2], got["jax"][2],
                                   rtol=1e-4, atol=1e-5)

    def test_static_fit_equals_dygraph_fit(self):
        """Same weights, same unshuffled data: the static path's loss
        equals the dygraph path's (the same ops and the same update)."""
        def run(static):
            m = _models(metrics=False, static=static)["torch"]
            if static:
                pt.enable_static()
            try:
                m.fit(_ds("torch", 64, 3), batch_size=16, epochs=2,
                      shuffle=False, verbose=0)
                return m.evaluate(_ds("torch", 64, 3), batch_size=16,
                                  verbose=0)["loss"]
            finally:
                if static:
                    pt.disable_static()

        np.testing.assert_allclose(np.asarray(run(True)),
                                   np.asarray(run(False)), rtol=1e-5)

    def test_requires_input_spec(self):
        pt.enable_static()
        try:
            model = thapi.Model(TLeNet())
            with pytest.raises(ValueError, match="InputSpec"):
                model.prepare(topt.SGD(0.1), loss=TF.cross_entropy)
        finally:
            pt.disable_static()

    def test_save_load_static(self, tmp_path):
        pt.enable_static()
        try:
            pt.seed(2)
            spec_in = [TSpec([None, 1, 28, 28], "float32", name="img")]
            spec_lb = [TSpec([None, 1], "int64", name="lbl")]
            net = TLeNet()
            model = thapi.Model(net, spec_in, spec_lb)
            model.prepare(topt.SGD(0.05, parameters=net.parameters()),
                          loss=TF.cross_entropy)
            model.fit(_ds("torch", 32, 4), batch_size=16, epochs=1,
                      verbose=0)
            x, _ = _toy(32, 4)
            want = model.predict_batch([x[:4]])[0]
            model.save(str(tmp_path / "ckpt"))
            pt.seed(99)
            net2 = TLeNet()
            m2 = thapi.Model(net2, spec_in, spec_lb)
            m2.prepare(topt.SGD(0.05, parameters=net2.parameters()),
                       loss=TF.cross_entropy)
            m2.load(str(tmp_path / "ckpt"))
            got = m2.predict_batch([x[:4]])[0]
        finally:
            pt.disable_static()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_update_false_refused(self):
        m = _models(metrics=False)["torch"]
        x, y = _toy(16)
        pt.enable_static()
        try:
            with pytest.raises(ValueError, match="update=False"):
                m.train_batch([x], [y], update=False)
        finally:
            pt.disable_static()
