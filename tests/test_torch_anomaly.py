"""paddle_tpu_torch's numerical self-healing (``hapi/anomaly.py``,
``Model.fit(anomaly=)``) against the JAX package's.

The twins of ``tests/test_anomaly.py``, on its MLP 8 -> 16 -> 1 and 10
batches of 4 (``Adam(1e-3)``, ``MSELoss``, ``shuffle=False``), the JAX
package's initial weights carried across by ``state_dict`` name, on
both of the port's paths (``accelerate`` True: the graphed step in its
guarded form; False: the eager step):

- a chaos ``nan_loss`` / ``nan_grad`` at batch K skips that step: the
  port's parameters are bit-equal to its own fit over the same batches
  without batch K, and within F32_TOL of the JAX package's skip run (the
  two packages' Adam steps differ by rounding only: a few ulps of ``lr``
  a step, ``tests/test_torch_hapi.py``);
- the spike detector flags the same steps as the JAX package's on the
  same loss sequences, and ``spike_action`` skip / tolerate behave as
  there (skip needs the graphed path, as in the JAX package);
- the audit names the same leaf; a ``corrupt_param`` rolls back to the
  newest verified checkpoint and ends bit-equal to the clean run (and to
  the JAX package's rollback run within F32_TOL); a repeated NaN fills
  the damage window and the replay passes over the poisoned batches;
  budget exhaustion and "no restorable checkpoint" raise ``FatalError``;
  a poisoned newest checkpoint is passed over.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.hapi.anomaly import AnomalyPolicy as JaxPolicy
from paddle_tpu.hapi.anomaly import LossSpikeDetector as JaxDetector
from paddle_tpu.hapi.anomaly import ParameterAudit as JaxAudit
from paddle_tpu.io.dataset import TensorDataset as JaxDataset
from paddle_tpu.testing import chaos as jchaos

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.framework.errors import (FatalError,
                                               InvalidArgumentError,
                                               ParameterCorruptionError)
from paddle_tpu_torch.framework.monitor import stat_get
from paddle_tpu_torch.hapi.anomaly import (AnomalyPolicy, AnomalyRuntime,
                                           LossSpikeDetector,
                                           ParameterAudit)
from paddle_tpu_torch.hapi.checkpoint import (TrainCheckpointer,
                                              capture_train_state)
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.nn.layer import state_from_numpy
from paddle_tpu_torch.profiler.flight_recorder import recorder
from paddle_tpu_torch.testing import chaos

BATCH, FEAT, HID = 4, 8, 16
N_BATCHES = 10
LR = 1e-3
# port against the JAX package after up to 12 Adam steps: Adam moves an
# entry by at most lr a step, and the two packages' gradients differ in
# the last bits (another summation order), which its normalized step
# turns into at most a few ulps of lr a step (tests/test_torch_hapi.py)
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def _jax_net():
    paddle.seed(1234)
    return jnn.Sequential(jnn.Linear(FEAT, HID), jnn.ReLU(),
                          jnn.Linear(HID, 1))


@pytest.fixture(scope="module")
def weights():
    return {k: np.asarray(v._value) for k, v in _jax_net().state_dict()
            .items()}


def jax_model(weights):
    net = _jax_net()
    m = paddle.Model(net)
    m.prepare(jopt.Adam(learning_rate=LR, parameters=net.parameters()),
              jnn.MSELoss())
    return m


def port_model(weights, accelerate=True):
    net = tnn.Sequential(tnn.Linear(FEAT, HID), tnn.ReLU(),
                         tnn.Linear(HID, 1))
    net.set_state_dict(state_from_numpy(weights, "cpu"))
    m = pt.Model(net)
    m.prepare(topt.Adam(learning_rate=LR, parameters=net.parameters()),
              tnn.MSELoss(), accelerate=accelerate)
    return m


def make_data(n_batches=N_BATCHES, y_scale=None):
    rng = np.random.RandomState(0)
    x = rng.randn(BATCH * n_batches, FEAT).astype(np.float32)
    w = rng.randn(FEAT, 1).astype(np.float32)
    y = (x @ w).astype(np.float32)
    if y_scale is not None:
        for idx, s in y_scale.items():
            y[idx * BATCH:(idx + 1) * BATCH] *= s
    return x, y


def fit_kwargs(**over):
    kw = dict(batch_size=BATCH, epochs=1, shuffle=False, verbose=0)
    kw.update(over)
    return kw


def port_params(m):
    return {k: v.numpy().copy() for k, v in m.network.state_dict().items()}


def jax_params(m):
    return {k: np.asarray(v) for k, v in m._state["params"].items()}


def same_bits(a, b):
    return a.keys() == b.keys() and all(
        a[k].tobytes() == b[k].tobytes() for k in a)


def close_to_jax(port, jax):
    assert port.keys() == jax.keys()
    for k in port:
        np.testing.assert_allclose(port[k], jax[k], rtol=0, atol=F32_TOL,
                                   err_msg=k)


def skip_only(policy=AnomalyPolicy, **over):
    kw = dict(rollback_after=None, spike_window=0)
    kw.update(over)
    return policy(**kw)


ACCEL = pytest.mark.parametrize("accelerate", [True, False],
                                ids=["graphed", "eager"])


class TestPolicyValidation:
    def test_bad_spike_action(self):
        with pytest.raises(InvalidArgumentError, match="spike_action"):
            AnomalyPolicy(spike_action="explode")

    @pytest.mark.parametrize("kw", [
        dict(spike_window=-1), dict(spike_k=0.0),
        dict(rollback_after=0), dict(rollback_window=0),
        dict(rollback_budget=-1), dict(audit_interval=0),
        dict(spike_window=4, spike_warmup=8)])
    def test_bad_numbers_raise_in_both_packages(self, kw):
        with pytest.raises(InvalidArgumentError):
            AnomalyPolicy(**kw)
        with pytest.raises(Exception):
            JaxPolicy(**kw)

    def test_fit_rejects_garbage_anomaly(self, weights):
        x, y = make_data(2)
        with pytest.raises(InvalidArgumentError, match="AnomalyPolicy"):
            port_model(weights).fit(TensorDataset([x, y]),
                                    **fit_kwargs(anomaly={"skip": True}))

    def test_rollback_armed_needs_checkpoint_dir(self, weights):
        x, y = make_data(2)
        with pytest.raises(InvalidArgumentError, match="checkpoint_dir"):
            port_model(weights).fit(TensorDataset([x, y]),
                                    **fit_kwargs(anomaly=True))

    @ACCEL
    def test_guard_mode_disarmed_after_fit(self, weights, accelerate):
        m = port_model(weights, accelerate)
        x, y = make_data(2)
        m.fit(TensorDataset([x, y]), **fit_kwargs(anomaly=skip_only()))
        assert m._anomaly_guard is False
        assert m._backup is None and m._last_guard is None
        outs = m.train_batch([x[:BATCH]], [y[:BATCH]])
        assert m._last_guard is None and len(outs) == 1

    def test_eager_spike_skip_rejected(self, weights):
        x, y = make_data(2)
        with pytest.raises(InvalidArgumentError, match="accelerated"):
            port_model(weights, accelerate=False).fit(
                TensorDataset([x, y]), **fit_kwargs(
                    anomaly=AnomalyPolicy(rollback_after=None,
                                          spike_action="skip")))

    def test_corrupt_param_fault_needs_leaf(self):
        with pytest.raises(ValueError, match="leaf"):
            chaos.Fault("train.step", at=1, action=chaos.CORRUPT_PARAM)

    @pytest.mark.parametrize("at", [1, 3, 17])
    def test_element_index_equals_the_jax_package(self, at):
        f = chaos.Fault("train.step", at=at, action=chaos.CORRUPT_PARAM,
                        leaf="0.weight")
        jf = jchaos.Fault("train.step", at=at,
                          action=jchaos.CORRUPT_PARAM, leaf="0.weight")
        for size in (1, 100, 128):
            assert f.element_index(size) == jf.element_index(size)
        assert f.leaf == jf.leaf == "0.weight"


class TestSpikeDetector:
    @pytest.mark.parametrize("seed", range(4))
    def test_flags_the_same_steps_as_the_jax_package(self, seed):
        rng = np.random.RandomState(seed)
        losses = np.abs(1.0 + 0.05 * rng.randn(60))
        losses[rng.choice(60, 6, replace=False)] *= rng.choice(
            [3.0, 30.0, 1e3], 6)
        losses[rng.randint(60)] = np.nan
        for window, k, warmup in ((16, 5.0, 4), (8, 10.0, 8), (0, 5.0, 1)):
            ours = LossSpikeDetector(window, k, warmup)
            ref = JaxDetector(window, k, warmup)
            got = [ours.observe(float(v)) for v in losses]
            want = [ref.observe(float(v)) for v in losses]
            assert got == want
            assert ours.threshold() == ref.threshold()

    def test_plateau_and_nonfinite(self):
        d = LossSpikeDetector(window=16, k=10.0, warmup=4)
        for _ in range(8):
            assert not d.observe(2.0)
        assert not d.observe(2.0000001)
        assert not d.observe(float("nan"))
        assert d.observe(100.0)
        d.reset()
        assert d.threshold() is None


class TestGuardedStep:
    @ACCEL
    def test_guard_on_clean_and_poisoned_steps(self, weights, accelerate):
        m = port_model(weights, accelerate)
        x, y = make_data(1)
        m._anomaly_guard = True
        outs = m.train_batch([x], [y])
        g = m._last_guard
        assert g["ok"] and np.isfinite(g["grad_norm"]) and g["grad_norm"] > 0
        assert outs[0] == g["loss"]
        before = port_params(m)
        outs = m.train_batch([np.full_like(x, np.nan)], [y])
        assert not m._last_guard["ok"] and len(outs) == 1
        m._discard_step()
        assert same_bits(port_params(m), before)
        assert m._optimizer._step_count == 1

    def test_grad_norm_matches_the_jax_package(self, weights):
        x, y = make_data(1)
        jm = jax_model(weights)
        jm._anomaly_guard = True
        jm.train_batch([x], [y])
        m = port_model(weights)
        m._anomaly_guard = True
        m.train_batch([x], [y])
        np.testing.assert_allclose(m._last_guard["grad_norm"],
                                   jm._last_guard["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(m._last_guard["loss"],
                                   jm._last_guard["loss"], rtol=1e-6)


class TestSkipStep:
    @ACCEL
    @pytest.mark.parametrize("action", [chaos.NAN_LOSS, chaos.NAN_GRAD])
    def test_skip_equals_the_run_without_batch_k(self, weights, action,
                                                  accelerate):
        K = 3
        x, y = make_data()
        sk0 = stat_get("train.anomaly.skipped_steps")
        m1 = port_model(weights, accelerate)
        plan = chaos.ChaosPlan([chaos.Fault("train.step", at=K + 1,
                                            action=action)])
        with chaos.running(plan):
            m1.fit(TensorDataset([x, y]),
                   **fit_kwargs(anomaly=skip_only()))
        assert stat_get("train.anomaly.skipped_steps") - sk0 == 1
        assert [f["site"] for f in plan.fired_log()] == ["train.step"]
        mask = np.ones(len(x), bool)
        mask[K * BATCH:(K + 1) * BATCH] = False
        m2 = port_model(weights, accelerate)
        m2.fit(TensorDataset([x[mask], y[mask]]),
               **fit_kwargs(anomaly=skip_only()))
        assert same_bits(port_params(m1), port_params(m2))
        assert m1._optimizer._step_count == N_BATCHES - 1

        jm = jax_model(weights)
        jplan = jchaos.ChaosPlan([jchaos.Fault("train.step", at=K + 1,
                                               action=action)])
        with jchaos.running(jplan):
            jm.fit(JaxDataset([x, y]),
                   **fit_kwargs(anomaly=skip_only(JaxPolicy)))
        close_to_jax(port_params(m1), jax_params(jm))

    def test_skip_keeps_callback_pairing(self, weights):
        from paddle_tpu_torch.hapi.callbacks import Callback

        class Pairing(Callback):
            begins = ends = 0

            def on_train_batch_begin(self, step, logs=None):
                Pairing.begins += 1

            def on_train_batch_end(self, step, logs=None):
                Pairing.ends += 1

        x, y = make_data()
        plan = chaos.ChaosPlan([chaos.Fault("train.step", at=3,
                                            action=chaos.NAN_LOSS)])
        with chaos.running(plan):
            port_model(weights).fit(TensorDataset([x, y]),
                                    callbacks=[Pairing()],
                                    **fit_kwargs(anomaly=skip_only()))
        assert Pairing.begins == N_BATCHES == Pairing.ends

    def test_spike_skip_and_tolerate(self, weights):
        K = 6
        x, y = make_data(y_scale={K: 1e3})
        pol = dict(rollback_after=None, spike_window=8, spike_k=6.0,
                   spike_warmup=3)
        s0 = stat_get("train.anomaly.loss_spikes")
        m_skip = port_model(weights)
        m_skip.fit(TensorDataset([x, y]), **fit_kwargs(
            anomaly=AnomalyPolicy(spike_action="skip", **pol)))
        assert stat_get("train.anomaly.loss_spikes") - s0 == 1
        mask = np.ones(len(x), bool)
        mask[K * BATCH:(K + 1) * BATCH] = False
        m_ref = port_model(weights)
        m_ref.fit(TensorDataset([x[mask], y[mask]]),
                  **fit_kwargs(anomaly=skip_only()))
        assert same_bits(port_params(m_skip), port_params(m_ref))

        jm = jax_model(weights)
        jm.fit(JaxDataset([x, y]), **fit_kwargs(
            anomaly=JaxPolicy(spike_action="skip", **pol)))
        close_to_jax(port_params(m_skip), jax_params(jm))

        m_tol = port_model(weights, accelerate=False)
        m_tol.fit(TensorDataset([x, y]), **fit_kwargs(
            anomaly=AnomalyPolicy(spike_action="tolerate", **pol)))
        assert stat_get("train.anomaly.loss_spikes") - s0 == 2
        assert not same_bits(port_params(m_tol), port_params(m_ref))


class TestAudit:
    @pytest.mark.parametrize("leaf_i", [0, 1, 3])
    def test_audit_names_the_leaf_the_jax_package_names(self, weights,
                                                        leaf_i):
        x, y = make_data(1)
        jm = jax_model(weights)
        jm.train_batch([x], [y])
        leaf = sorted(jm._state["params"])[leaf_i]
        arr = jm._state["params"][leaf]
        jm._state["params"][leaf] = arr.reshape(-1).at[0].set(
            np.nan).reshape(arr.shape)
        m = port_model(weights)
        m.train_batch([x], [y])
        assert ParameterAudit().corrupted_leaf(m) is None
        with torch.no_grad():
            dict(m.network.named_parameters())[leaf]._value.view(-1)[0] = \
                float("nan")
        assert ParameterAudit().corrupted_leaf(m) == leaf \
            == JaxAudit().corrupted_leaf(jm)

    @ACCEL
    def test_skip_only_corruption_is_typed_fatal(self, weights, accelerate):
        x, y = make_data(6)
        plan = chaos.ChaosPlan([chaos.Fault(
            "train.step", at=2, action=chaos.CORRUPT_PARAM,
            leaf="0.weight")])
        with chaos.running(plan):
            with pytest.raises(ParameterCorruptionError, match="0.weight"):
                port_model(weights, accelerate).fit(
                    TensorDataset([x, y]),
                    **fit_kwargs(anomaly=skip_only(audit_interval=1)))


class TestRollback:
    @ACCEL
    def test_corrupt_param_rollback_matches_clean(self, weights, tmp_path,
                                                  accelerate):
        x, y = make_data(12)
        kw = dict(rollback_after=10, rollback_window=32, rollback_budget=2,
                  audit_interval=2, spike_window=0)
        leaf = "2.weight"

        def run(d, poison, pkg="port"):
            if pkg == "port":
                m, ch, pol = port_model(weights, accelerate), chaos, \
                    AnomalyPolicy(**kw)
                data = TensorDataset([x, y])
            else:
                m, ch, pol = jax_model(weights), jchaos, JaxPolicy(**kw)
                data = JaxDataset([x, y])
            plan = ch.ChaosPlan([ch.Fault("train.step", at=6,
                                          action=ch.CORRUPT_PARAM,
                                          leaf=leaf)] if poison else [])
            with ch.running(plan):
                m.fit(data, **fit_kwargs(
                    checkpoint_dir=str(d), checkpoint_interval=2,
                    checkpoint_async=False, anomaly=pol))
            return m

        rb0 = stat_get("train.anomaly.rollbacks")
        recorder.reset()
        m1 = run(tmp_path / "a", True)
        assert stat_get("train.anomaly.rollbacks") - rb0 == 1
        trans = recorder.build_bundle("test")["transitions"]
        corr = [t for t in trans if t["kind"] == "train.corruption"]
        assert corr and corr[0]["target"] == leaf
        assert any(t["kind"] == "train.rollback" for t in trans)
        m_ref = run(tmp_path / "ref", False)
        assert same_bits(port_params(m1), port_params(m_ref))
        jm = run(tmp_path / "jax", True, pkg="jax")
        close_to_jax(port_params(m1), jax_params(jm))

    @ACCEL
    def test_damage_threshold_rollback_passes_over_poisoned(
            self, weights, tmp_path, accelerate):
        K = 5
        x, y = make_data(12)
        pol = AnomalyPolicy(rollback_after=2, rollback_window=8,
                            rollback_budget=2, spike_window=0)
        rb0 = stat_get("train.anomaly.rollbacks")
        m1 = port_model(weights, accelerate)
        plan = chaos.ChaosPlan([chaos.Fault(
            "train.step", at=K + 1, action=chaos.NAN_LOSS, count=3)])
        with chaos.running(plan):
            m1.fit(TensorDataset([x, y]), **fit_kwargs(
                checkpoint_dir=str(tmp_path / "a"), checkpoint_interval=2,
                checkpoint_async=False, anomaly=pol))
        assert stat_get("train.anomaly.rollbacks") - rb0 == 1
        # as in the JAX package: batches K-1, K and K+1 contribute nothing
        mask = np.ones(len(x), bool)
        mask[(K - 1) * BATCH:(K + 2) * BATCH] = False
        m2 = port_model(weights, accelerate)
        m2.fit(TensorDataset([x[mask], y[mask]]),
               **fit_kwargs(anomaly=skip_only()))
        assert same_bits(port_params(m1), port_params(m2))

    @ACCEL
    def test_rollback_budget_exhaustion_is_fatal(self, weights, tmp_path,
                                                 accelerate):
        x, y = make_data(12)
        pol = AnomalyPolicy(rollback_after=10, rollback_window=32,
                            rollback_budget=0, audit_interval=1,
                            spike_window=0)
        plan = chaos.ChaosPlan([chaos.Fault(
            "train.step", at=4, action=chaos.CORRUPT_PARAM,
            leaf="0.weight")])
        with chaos.running(plan):
            with pytest.raises(FatalError, match="budget"):
                port_model(weights, accelerate).fit(
                    TensorDataset([x, y]), **fit_kwargs(
                        checkpoint_dir=str(tmp_path), checkpoint_interval=2,
                        checkpoint_async=False, anomaly=pol))

    @ACCEL
    def test_no_restorable_checkpoint_is_fatal(self, weights, tmp_path,
                                               accelerate):
        x, y = make_data(8)
        pol = AnomalyPolicy(rollback_after=10, rollback_window=32,
                            rollback_budget=2, audit_interval=1,
                            spike_window=0)
        plan = chaos.ChaosPlan([chaos.Fault(
            "train.step", at=1, action=chaos.CORRUPT_PARAM,
            leaf="0.weight")])
        with chaos.running(plan):
            with pytest.raises(FatalError, match="no verified"):
                port_model(weights, accelerate).fit(
                    TensorDataset([x, y]), **fit_kwargs(
                        checkpoint_dir=str(tmp_path),
                        checkpoint_interval=100, checkpoint_async=False,
                        anomaly=pol))

    def test_rollback_skips_poisoned_checkpoint(self, weights, tmp_path):
        m = port_model(weights)
        x, y = make_data(1)
        m.train_batch([x], [y])
        ckpt = TrainCheckpointer(str(tmp_path), async_write=False)
        ckpt.store.save(capture_train_state(
            m, global_step=1, epoch=0, next_batch=1), 1)
        clean = port_params(m)
        with torch.no_grad():
            dict(m.network.named_parameters())["0.weight"]._value.view(
                -1)[0] = float("nan")
        ckpt.store.save(capture_train_state(
            m, global_step=2, epoch=0, next_batch=2), 2)
        rt = AnomalyRuntime(AnomalyPolicy(rollback_after=2,
                                          rollback_budget=2,
                                          spike_window=0),
                            checkpointer=ckpt)
        cc0 = stat_get("train.anomaly.corrupt_checkpoints")
        pos = rt.perform_rollback(m, "poisoned-newest")
        assert pos["global_step"] == 1
        assert stat_get("train.anomaly.corrupt_checkpoints") - cc0 == 1
        assert ParameterAudit().corrupted_leaf(m) is None
        assert same_bits(port_params(m), clean)
