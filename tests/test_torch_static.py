"""paddle_tpu_torch.static (Program / Executor) against paddle_tpu.static.

The twins of ``tests/test_static.py`` and the recording half of
``tests/test_dy2static_loud.py``: the same programs are built in both
packages, the JAX package's weights carried across by ``state_dict``
name (``state_from_numpy``), the same numpy feeds run through both
Executors.  Tolerances: forward fetches rtol 1e-5 (f32, the CPU); losses
of SGD / Momentum / Adam steps rtol 1e-5.  LeNet runs against the port's
own dygraph loop here (rtol 1e-5: the same ops, the same update) and
against the JAX package's static path in
``tests/test_torch_hapi_static.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import static as jstatic
from paddle_tpu.jit import control_flow as jcf

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.jit import control_flow as tcf
from paddle_tpu_torch.nn.layer import state_from_numpy
from paddle_tpu_torch.vision.models import LeNet

PKG = {"jax": (paddle, jnn, JF, jopt, jstatic),
       "torch": (pt, tnn, TF, topt, tstatic)}


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


def _carry(jax_layer, port_layer):
    port_layer.set_state_dict(state_from_numpy(
        {k: np.asarray(v._value) for k, v in jax_layer.state_dict().items()},
        "cpu"))


def _regression(pkg, make_opt, n_in=8, batch=16):
    """A Linear regression program: (main, loss, pred, layer, opt)."""
    api, nn, F, O, st = PKG[pkg]
    main = st.Program()
    with st.program_guard(main):
        x = st.data("x", [batch, n_in], "float32")
        y = st.data("y", [batch, 1], "float32")
        lin = nn.Linear(n_in, 1)
        pred = lin(x)
        loss = F.mse_loss(pred, y)
        opt = make_opt(O, lin)
        opt.minimize(loss)
    return main, loss, pred, lin, opt


def _train_both(make_opt, steps, seed=0, n_in=8, batch=16):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(n_in, 1).astype(np.float32)
    feeds = []
    for _ in range(steps):
        xv = rng.randn(batch, n_in).astype(np.float32)
        feeds.append({"x": xv, "y": xv @ w_true})
    out = {}
    paddle.seed(0)
    jm = _regression("jax", make_opt, n_in, batch)
    tm = _regression("torch", make_opt, n_in, batch)
    _carry(jm[3], tm[3])
    for pkg, (main, loss, _, lin, _) in (("jax", jm), ("torch", tm)):
        exe = PKG[pkg][4].Executor()
        losses = [float(exe.run(main, feed=fd, fetch_list=[loss])[0])
                  for fd in feeds]
        out[pkg] = (losses, np.asarray(lin.weight.numpy()), main)
    return out


class TestExecutorReplay:
    def test_new_feeds_recompute_fetches(self):
        got = {}
        for pkg in PKG:
            st = PKG[pkg][4]
            main = st.Program()
            with st.program_guard(main):
                x = st.data("x", [None, 4], "float32")
                y = x * 2.0 + 1.0
            exe = st.Executor()
            got[pkg] = [exe.run(main, feed={"x": np.full((2, 4), v,
                                                         np.float32)},
                                fetch_list=[y])[0] for v in (1.0, 5.0)]
        for a, b in zip(got["jax"], got["torch"]):
            np.testing.assert_allclose(b, a, rtol=1e-6)
        np.testing.assert_allclose(got["torch"][1], np.full((2, 4), 11.0))

    def test_layer_program(self):
        paddle.seed(0)
        xv = np.random.RandomState(0).randn(3, 8).astype(np.float32)
        outs, layers = {}, {}
        for pkg in PKG:
            _, nn, _, _, st = PKG[pkg]
            main = st.Program()
            with st.program_guard(main):
                x = st.data("x", [3, 8], "float32")
                layers[pkg] = nn.Linear(8, 2)
                out = layers[pkg](x)
            if pkg == "torch":
                _carry(layers["jax"], layers["torch"])
            outs[pkg] = st.Executor().run(main, feed={"x": xv},
                                          fetch_list=[out])[0]
        np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-5,
                                   atol=1e-6)

    def test_sgd_training_matches_jax(self):
        res = _train_both(lambda O, lin: O.SGD(
            learning_rate=0.1, parameters=lin.parameters()), 30)
        np.testing.assert_allclose(res["torch"][0], res["jax"][0],
                                   rtol=1e-5)
        assert res["torch"][0][-1] < res["torch"][0][0] * 0.2

    def test_momentum_state_persists_and_matches(self):
        res = _train_both(lambda O, lin: O.Momentum(
            learning_rate=0.05, momentum=0.9, parameters=lin.parameters()),
            6, seed=1, n_in=4, batch=8)
        np.testing.assert_allclose(res["torch"][0], res["jax"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["torch"][1], res["jax"][1],
                                   rtol=1e-5, atol=1e-6)
        main = res["torch"][2]
        vel = [t for t, *_ in main._state_writeback.values()
               if t._value.dim() == 2]
        assert vel and any(float(t._value.abs().sum()) > 0 for t in vel)

    def test_static_momentum_matches_eager(self):
        rng = np.random.RandomState(1)
        w_true = rng.randn(4, 1).astype(np.float32)
        data = [rng.randn(8, 4).astype(np.float32) for _ in range(6)]
        pt.seed(0)
        lin_e = tnn.Linear(4, 1)
        w0 = {k: v.numpy() for k, v in lin_e.state_dict().items()}
        opt_e = topt.Momentum(learning_rate=0.05, momentum=0.9,
                              parameters=lin_e.parameters())
        for xv in data:
            loss = TF.mse_loss(lin_e(pt.to_tensor(xv)),
                               pt.to_tensor(xv @ w_true))
            loss.backward()
            opt_e.step()
            opt_e.clear_grad()
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [8, 4], "float32")
            y = tstatic.data("y", [8, 1], "float32")
            lin_s = tnn.Linear(4, 1)
            lin_s.set_state_dict(state_from_numpy(w0, "cpu"))
            loss = TF.mse_loss(lin_s(x), y)
            topt.Momentum(learning_rate=0.05, momentum=0.9,
                          parameters=lin_s.parameters()).minimize(loss)
        exe = tstatic.Executor()
        for xv in data:
            exe.run(main, feed={"x": xv, "y": xv @ w_true},
                    fetch_list=[loss])
        np.testing.assert_allclose(lin_s.weight.numpy(),
                                   lin_e.weight.numpy(), rtol=1e-5,
                                   atol=1e-6)

    def test_adam_step_counter_advances(self):
        res = _train_both(lambda O, lin: O.Adam(
            learning_rate=0.1, parameters=lin.parameters()), 3, n_in=2,
            batch=4)
        np.testing.assert_allclose(res["torch"][0], res["jax"][0],
                                   rtol=1e-5)
        steps = [t for t, *_ in res["torch"][2]._state_writeback.values()
                 if t._value.dim() == 0 and t._value.dtype == torch.int32]
        assert steps and int(steps[0]._value) == 3

    def test_lr_scheduler_applies(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [4, 2], "float32")
            lin = tnn.Linear(2, 2, bias_attr=False)
            loss = (lin(x) * lin(x)).sum()
            sched = topt.lr.StepDecay(learning_rate=0.1, step_size=1,
                                      gamma=0.0)
            topt.SGD(learning_rate=sched,
                     parameters=lin.parameters()).minimize(loss)
        exe = tstatic.Executor()
        xv = np.ones((4, 2), np.float32)
        w0 = lin.weight.numpy()
        exe.run(main, feed={"x": xv}, fetch_list=[loss])
        assert not np.array_equal(lin.weight.numpy(), w0)
        sched.step()                      # lr -> 0: the weights stop
        w1 = lin.weight.numpy()
        exe.run(main, feed={"x": xv}, fetch_list=[loss])
        np.testing.assert_array_equal(lin.weight.numpy(), w1)

    def test_dropout_varies_across_runs(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [4, 64], "float32")
            out = TF.dropout(x, p=0.5, training=True)
        exe = tstatic.Executor()
        xv = np.ones((4, 64), np.float32)
        o1, = exe.run(main, feed={"x": xv}, fetch_list=[out])
        o2, = exe.run(main, feed={"x": xv}, fetch_list=[out])
        assert not np.array_equal(o1, o2)
        assert set(np.unique(o1)) <= {0.0, 2.0}

    def test_fetch_by_name_and_missing(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [2, 2], "float32")
            y = x + 1.0
        exe = tstatic.Executor()
        got, = exe.run(main, feed={"x": np.zeros((2, 2), np.float32)},
                       fetch_list=[y.name])
        np.testing.assert_allclose(got, np.ones((2, 2)))
        with pytest.raises(KeyError):
            exe.run(main, feed={"x": np.zeros((2, 2), np.float32)},
                    fetch_list=["nope"])
        with pytest.raises(ValueError, match="not fed"):
            exe.run(main, feed={}, fetch_list=[y])

    def test_program_save_load_roundtrip(self, tmp_path):
        paddle.seed(0)
        xv = np.random.RandomState(2).randn(2, 8).astype(np.float32)
        got = {}
        lins = {}
        for pkg in PKG:
            _, nn, F, _, st = PKG[pkg]
            main = st.Program()
            with st.program_guard(main):
                x = st.data("x", [2, 8], "float32")
                lins[pkg] = nn.Linear(8, 3)
                if pkg == "torch":
                    _carry(lins["jax"], lins["torch"])
                out = F.relu(lins[pkg](x))
            path = str(tmp_path / f"static_lin_{pkg}")
            main.save(path, fetch_list=[out])
            got[pkg] = st.load_inference_program(path).run({"x": xv})[0]
        np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-5,
                                   atol=1e-6)

    def test_save_train_resumes_in_step(self, tmp_path):
        rng = np.random.RandomState(3)
        main, loss, _, lin, _ = _regression(
            "torch", lambda O, lin: O.Adam(0.05,
                                           parameters=lin.parameters()),
            n_in=4, batch=8)
        feeds = [{"x": rng.randn(8, 4).astype(np.float32),
                  "y": rng.randn(8, 1).astype(np.float32)}
                 for _ in range(4)]
        exe = tstatic.Executor()
        exe.run(main, feed=feeds[0], fetch_list=[loss])
        main.save_train(str(tmp_path / "tr"), fetch_list=[loss])
        loaded = tstatic.load_train_program(str(tmp_path / "tr"))
        for fd in feeds[1:]:
            want = exe.run(main, feed=fd, fetch_list=[loss])[0]
            got = loaded.run(fd)[0]
            np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(loaded.state_dict()[lin.weight.name],
                                   lin.weight.numpy(), rtol=1e-6)

    def test_lenet_trains_like_eager(self):
        """LeNet through the Executor: the same losses as the dygraph loop
        from the same weights (LeNet against the JAX package's static
        path is tests/test_torch_hapi_static.py's)."""
        rng = np.random.RandomState(0)
        xv = rng.randn(16, 1, 28, 28).astype(np.float32)
        yv = rng.randint(0, 10, (16,)).astype(np.int64)
        pt.seed(0)
        net_e = LeNet(num_classes=10)
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [16, 1, 28, 28], "float32")
            y = tstatic.data("y", [16], "int64")
            net = LeNet(num_classes=10)
            net.set_state_dict(net_e.state_dict())
            loss = TF.cross_entropy(net(x), y)
            topt.Adam(learning_rate=1e-3,
                      parameters=net.parameters()).minimize(loss)
        exe = tstatic.Executor()
        got = [float(exe.run(main, feed={"x": xv, "y": yv},
                             fetch_list=[loss])[0]) for _ in range(8)]
        opt = topt.Adam(learning_rate=1e-3, parameters=net_e.parameters())
        want = []
        for _ in range(8):
            le = TF.cross_entropy(net_e(pt.to_tensor(xv)), pt.to_tensor(yv))
            le.backward()
            opt.step()
            opt.clear_grad()
            want.append(float(le))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got[-1] < got[0] * 0.8


    def test_custom_op_trains_static(self):
        """The twin of tests/test_custom_op.py's test_trains_static: a
        registered op (row t's scale_shift with its vjp) records into a
        Program and the Executor replays it with the backward and the
        update; the losses equal the same steps eagerly."""
        from paddle_tpu_torch.ops.scale_shift import (scale_shift,
                                                      scale_shift_vjp)
        from paddle_tpu_torch.utils import register_op

        op = register_op("t_static", scale_shift, vjp=scale_shift_vjp,
                         exist_ok=True)
        rng = np.random.RandomState(0)
        feeds = []
        for _ in range(10):
            xv = rng.randn(16, 8).astype(np.float32)
            feeds.append((xv, (xv.sum(axis=1, keepdims=True) * 0.05)
                          .astype(np.float32)))
        pt.seed(0)
        lin_e = tnn.Linear(8, 1)
        w0 = {k: v.numpy() for k, v in lin_e.state_dict().items()}
        scale, shift = (pt.to_tensor(np.float32(v)) for v in (1.5, 0.25))
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [16, 8], "float32")
            y = tstatic.data("y", [16, 1], "float32")
            lin = tnn.Linear(8, 1)
            lin.set_state_dict(state_from_numpy(w0, "cpu"))
            loss = ((op(lin(x), scale, shift) - y) ** 2).mean()
            topt.SGD(learning_rate=0.05,
                     parameters=lin.parameters()).minimize(loss)
        exe = tstatic.Executor()
        got = [float(exe.run(main, feed={"x": a, "y": b},
                             fetch_list=[loss])[0]) for a, b in feeds]
        opt = topt.SGD(learning_rate=0.05, parameters=lin_e.parameters())
        want = []
        for a, b in feeds:
            le = ((op(lin_e(pt.to_tensor(a)), scale, shift)
                   - pt.to_tensor(b)) ** 2).mean()
            le.backward()
            opt.step()
            opt.clear_grad()
            want.append(float(le))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert got[-1] < got[0]


class TestRecording:
    """The recording half of tests/test_dy2static_loud.py."""

    def test_bool_during_recording_raises(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [2], "float32")
            y = x * 2.0
            with pytest.raises(TypeError,
                               match="static Program is recording"):
                if y.sum() > 0:
                    y = y + 1.0
            for coerce in (float, int):
                with pytest.raises(TypeError, match="recording"):
                    coerce(y.sum())

    def test_closure_cond_during_recording_raises(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [2], "float32")
            with pytest.raises(TypeError, match="traced_cond"):
                tcf.cond(x.sum() > 0, lambda: x, lambda: -x)
            with pytest.raises(TypeError, match="traced_cond"):
                pt.nn.cond(x.sum() > 0, lambda: x, lambda: -x)

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_traced_cond_records_both_branches(self, pkg):
        st = PKG[pkg][4]
        cf = jcf if pkg == "jax" else tcf
        main = st.Program()
        with st.program_guard(main):
            x = st.data("x", [2], "float32")
            out = cf.traced_cond(x.sum() > 0, lambda v: v * 2.0,
                                 lambda v: -v, x)
        exe = st.Executor()
        pos = np.asarray([1.0, 2.0], np.float32)
        neg = np.asarray([-1.0, -2.0], np.float32)
        np.testing.assert_allclose(
            exe.run(main, feed={"x": pos}, fetch_list=[out])[0], pos * 2)
        np.testing.assert_allclose(
            exe.run(main, feed={"x": neg}, fetch_list=[out])[0], -neg)

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_while_loop_records_and_replays(self, pkg):
        st = PKG[pkg][4]
        cf = jcf if pkg == "jax" else tcf
        main = st.Program()
        with st.program_guard(main):
            x = st.data("x", [1], "float32")
            out, = cf.while_loop(lambda v: v.sum() < 10.0,
                                 lambda v: (v + 1.0,), (x,))
        exe = st.Executor()
        for start, want in ((0.0, 10.0), (7.5, 10.5)):
            got, = exe.run(main, feed={"x": np.asarray([start],
                                                       np.float32)},
                           fetch_list=[out])
            np.testing.assert_allclose(got, [want], rtol=1e-6)

    def test_no_kernel_launch_while_recording(self):
        from paddle_tpu_torch.ops.attention import ROUTE_STATS

        pt.seed(0)
        mha = tnn.MultiHeadAttention(16, 2)
        before = dict(ROUTE_STATS)
        main = tstatic.Program()
        with tstatic.program_guard(main):
            q = tstatic.data("q", [2, 8, 16], "float32")
            out = mha(q, q, q)
        assert ROUTE_STATS == before and out.shape == [2, 8, 16]
        qv = np.random.RandomState(0).randn(2, 8, 16).astype(np.float32)
        got, = tstatic.Executor().run(main, feed={"q": qv},
                                      fetch_list=[out])
        assert ROUTE_STATS["xla"] == before["xla"] + 1
        qt = pt.to_tensor(qv)
        np.testing.assert_allclose(got, mha(qt, qt, qt).numpy(), rtol=1e-5,
                                   atol=1e-6)


class TestStaticSurface:
    def test_static_nn_layers_match_eager(self):
        rng = np.random.RandomState(4)
        xv = rng.randn(2, 3, 8, 8).astype(np.float32)
        ids = rng.randint(0, 10, (2, 5)).astype(np.int64)
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [2, 3, 8, 8], "float32")
            i = tstatic.data("i", [2, 5], "int64")
            c = tstatic.nn.conv2d(x, 4, 3, padding=1, act="relu")
            b = tstatic.nn.batch_norm(c, is_test=True)
            f = tstatic.nn.fc(b, 6, activation="tanh")
            ln = tstatic.nn.layer_norm(f, begin_norm_axis=1)
            e = tstatic.nn.embedding(i, [10, 4])
        got = tstatic.Executor().run(main, feed={"x": xv, "i": ids},
                                     fetch_list=[ln, e])
        assert got[0].shape == (2, 6) and got[1].shape == (2, 5, 4)
        np.testing.assert_allclose(got[0].mean(axis=1), 0.0, atol=1e-5)
        assert np.isfinite(got[0]).all()

    def test_append_backward_and_gradients(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [3, 2], "float32")
            lin = tnn.Linear(2, 1)
            loss = (lin(x) ** 2).mean()
            pairs = tstatic.append_backward(loss)
            gx, = tstatic.gradients([loss], [x])
        xv = np.random.RandomState(5).randn(3, 2).astype(np.float32)
        fetched = tstatic.Executor().run(
            main, feed={"x": xv}, fetch_list=[g for _, g in pairs] + [gx])
        xt = pt.to_tensor(xv, stop_gradient=False)
        eloss = (lin(xt) ** 2).mean()
        eloss.backward()
        by_id = {id(p): g for (p, _), g in zip(pairs, fetched)}
        np.testing.assert_allclose(by_id[id(lin.weight)],
                                   lin.weight.grad.numpy(), rtol=1e-5)
        np.testing.assert_allclose(fetched[-1], xt.grad.numpy(), rtol=1e-5)

    def test_item_11_refusals(self, tmp_path):
        """``with_data_parallel`` over several devices still raises; the
        dataset-driven Executor calls run (fleet's ``MultiTrainer``; held
        against the JAX package in ``tests/test_torch_dataset_trainer.py``)."""
        from paddle_tpu_torch.distributed.fleet import InMemoryDataset
        from paddle_tpu_torch.io.multislot import Slot, write_multislot_file

        main = tstatic.Program()
        with pytest.raises(InvalidArgumentError, match="item 11"):
            tstatic.CompiledProgram(main).with_data_parallel(
                places=tstatic.cpu_places(2))
        slots = [Slot("v", "float32", is_dense=True, dim=2)]
        path = str(tmp_path / "d.txt")
        write_multislot_file(path, [{"v": [i, 1.0]} for i in range(4)],
                             slots)
        ds = InMemoryDataset()
        ds.set_slots(slots)
        ds.set_filelist([path])
        ds.set_batch_size(2)
        ds.load_into_memory()
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            v = tstatic.data("v", [2, 2], "float32")
            s = v.sum()
        for run in (tstatic.Executor().train_from_dataset,
                    tstatic.Executor().infer_from_dataset):
            out = run(prog, dataset=ds, fetch_list=[s])
            assert out["batches"] == 2 and out["losses"] == [3.0, 7.0]
        with pytest.raises(ValueError, match="dataset is required"):
            tstatic.Executor().train_from_dataset(main)
        # one device: a CompiledProgram runs as its program
        with tstatic.program_guard(main):
            x = tstatic.data("x", [2], "float32")
            y = x * 3.0
        got, = tstatic.Executor().run(
            tstatic.CompiledProgram(main).with_data_parallel(),
            feed={"x": np.ones(2, np.float32)}, fetch_list=[y])
        np.testing.assert_allclose(got, [3.0, 3.0])

    def test_print_runs_at_replay(self, capfd):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [2], "float32")
            y = tstatic.Print(x * 2.0, message="seen")
        capfd.readouterr()
        got, = tstatic.Executor().run(
            main, feed={"x": np.asarray([1.0, 3.0], np.float32)},
            fetch_list=[y])
        np.testing.assert_allclose(got, [2.0, 6.0])
        assert "seen" in capfd.readouterr().err

    def test_inference_model_and_program_bytes(self, tmp_path):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [2, 4], "float32")
            lin = tnn.Linear(4, 3)
            out = lin(x)
        xv = np.random.RandomState(6).randn(2, 4).astype(np.float32)
        want = lin(pt.to_tensor(xv)).numpy()
        exe = tstatic.Executor()
        prefix = str(tmp_path / "inf")
        tstatic.save_inference_model(prefix, [x], [out], exe, program=main)
        prog, feeds, fetches = tstatic.load_inference_model(prefix, exe)
        assert feeds == ["x"] and fetches == [0]
        np.testing.assert_allclose(prog.run({"x": xv})[0], want, rtol=1e-5)
        blob = tstatic.serialize_program([x], [out], program=main)
        again = tstatic.deserialize_program(blob)
        np.testing.assert_allclose(again.run({"x": xv})[0], want, rtol=1e-5)

    def test_case_and_switch_case_match_jax(self):
        got = {}
        for pkg in PKG:
            api, _, _, _, st = PKG[pkg]
            x = api.to_tensor(np.asarray([1.0, -2.0], np.float32))
            outs = [st.nn.case([(x.sum() > 0, lambda: x * 2.0),
                                (x.sum() < 0, lambda: x * 3.0)],
                               default=lambda: -x),
                    st.nn.switch_case(api.to_tensor(np.int32(1)),
                                      [lambda: x + 1.0, lambda: x + 2.0]),
                    st.nn.switch_case(api.to_tensor(np.int32(7)),
                                      {1: lambda: x, 3: lambda: x * 5.0},
                                      default=lambda: x - 9.0),
                    st.nn.cond(x.mean() > 0, lambda: x, lambda: -x)]
            got[pkg] = [o.numpy() for o in outs]
        for a, b in zip(got["jax"], got["torch"]):
            np.testing.assert_allclose(b, a, rtol=1e-6)

    def test_py_func_records_forward_and_backward(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [3], "float32")
            y = tstatic.py_func(lambda a: np.tanh(a), x * 1.0,
                                out=((3,), "float32"),
                                backward_func=lambda a, g: g * (1 - np.tanh(a) ** 2))
            gx, = tstatic.gradients([y.sum()], [x])
        xv = np.asarray([0.1, -0.5, 2.0], np.float32)
        out, g = tstatic.Executor().run(main, feed={"x": xv},
                                        fetch_list=[y, gx])
        np.testing.assert_allclose(out, np.tanh(xv), rtol=1e-6)
        np.testing.assert_allclose(g, 1 - np.tanh(xv) ** 2, rtol=1e-5)

    def test_scope_and_tensor_fetches(self):
        main = tstatic.Program()
        with tstatic.program_guard(main):
            x = tstatic.data("x", [2, 3], "float32")
            lin = tnn.Linear(3, 2)
            out = lin(x)
        scope = tstatic.Scope()
        xv = np.ones((2, 3), np.float32)
        with tstatic.scope_guard(scope):
            got, = tstatic.Executor().run(main, feed={"x": xv},
                                          fetch_list=[out],
                                          return_numpy=False)
        assert isinstance(got, pt.Tensor)
        np.testing.assert_allclose(got.numpy(),
                                   lin(pt.to_tensor(xv)).numpy(), rtol=1e-6)
        assert scope.find_var(lin.weight.name) is lin.weight._value
        np.testing.assert_allclose(scope.find_var(out.name).numpy(),
                                   got.numpy())

    def test_traced_layer_saves_an_inference_model(self, tmp_path):
        pt.seed(0)
        net = tnn.Sequential(tnn.Linear(4, 3), tnn.ReLU())
        x = pt.to_tensor(np.random.RandomState(7).randn(2, 4)
                         .astype(np.float32))
        outs, traced = pt.jit.TracedLayer.trace(net, [x])
        path = str(tmp_path / "traced")
        traced.save_inference_model(path)
        np.testing.assert_allclose(pt.jit.load(path, device="cpu")(x)
                                   .numpy(), outs.numpy(), rtol=1e-6)

    def test_mode_switches(self):
        assert pt.in_dynamic_mode() and pt.in_dygraph_mode()
        pt.enable_static()
        try:
            assert not pt.in_dynamic_mode()
            assert tstatic.static_mode_enabled()
        finally:
            pt.disable_static()
        assert pt.in_dynamic_mode()
