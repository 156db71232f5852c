"""paddle_tpu_torch's hapi ``Model`` against the JAX package's.

- LeNet on the synthetic MNIST (the first 64 images, batches of 32,
  ``Adam(1e-3)``, ``CrossEntropyLoss``, ``Accuracy``), the JAX package's
  weights carried across with ``state_from_numpy``: ``fit`` with
  ``accelerate`` True and False against the JAX package's
  ``accelerate=False``; losses within rtol 1e-4 and weights within 2e-5
  (the tolerance of ``tests/test_torch_lenet.py``: the gradients differ
  by rounding only, Adam's normalized step turns that into a few ulps of
  ``lr`` per step).
- A 2-layer, 32-wide GPT, ``AdamW`` over ``LinearWarmup(
  CosineAnnealingDecay)`` with ``ClipGradByGlobalNorm(1.0)`` and the
  ``LRScheduler`` callback, 2 epochs of 2 shuffled batches: ``fit`` with
  ``accelerate`` True and False against the JAX package's
  ``accelerate=False``, and at a constant LR with no clip against its
  ``accelerate=True``.  The two port paths are bit-equal.  Tolerances
  are those of ``tests/test_torch_train.py::test_training_steps_match_
  jax``: losses 1e-4; every weight within ``2 · lr · steps``, and at
  most 1 % of them beyond ``2e-3 · lr``.  Adam divides by
  ``sqrt(v̂) + 1e-8``, so an entry whose gradient is at the rounding
  noise floor takes a normalized step of about ±1 in either package:
  the key projection's bias always (its exact gradient is 0: a softmax
  row is invariant to a constant added to its scores), so it is left out
  of the 1 %, and a few others at a constant LR of 1e-2.
- ``evaluate``/``predict`` against the network's own forward,
  ``save``/``load``, a checkpointed ``fit`` interrupted and resumed
  bit-equal to the uninterrupted one, the callbacks' event order against
  the JAX package's, ``summary``'s parameter count.
- The JAX package's accelerated step bakes the learning rate at trace
  time and drops ``grad_clip`` — pinned here as reference behaviour; the
  port's graphed step honours both.
- Randomness in the train step (dropout on the flash and the plain
  attention routes and in the residual path, ``Dpsgd``'s noise) draws
  from the port's generator only: two runs from one ``pt.seed`` are
  bit-equal on both paths, and each step draws anew (at LR 0 the same
  batch gives another loss).  The card tests hold the graphed replays
  to the eager draws.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu.nn as jnn
from paddle_tpu import metric as jmetric
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit.functional import get_state
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.text.models import GPTModel as JaxGPT
from paddle_tpu.vision.datasets import MNIST as JaxMNIST
from paddle_tpu.vision.models import LeNet as JaxLeNet

import paddle_tpu_torch as pt
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.nn.layer import state_from_numpy
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.profiler.jit_cost import compile_budget
from paddle_tpu_torch.text.models import (GPTModel, load_numpy_state,
                                          numpy_state)
from paddle_tpu_torch.vision.datasets import MNIST
from paddle_tpu_torch.vision.models import LeNet

CFG = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=2,
           ffn_size=64, max_seq_len=64)
LR, WD, EPOCHS, SEQS, BATCH, S = 1e-2, 0.1, 2, 8, 4, 24
STEPS = EPOCHS * SEQS // BATCH
NOISE = "attn.k_proj.bias"
PKG = {"jax": (paddle, jio, jnn, jopt, jlr),
       "torch": (pt, tio, tnn, topt, tlr)}


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


@pytest.fixture(scope="module")
def tokens():
    ids = np.random.RandomState(0).randint(
        0, CFG["vocab_size"], (SEQS, S + 1)).astype(np.int64)
    return ids[:, :-1], ids[:, 1:]


@pytest.fixture(scope="module")
def gpt_weights():
    paddle.seed(3)
    m = JaxGPT(**CFG, dropout=0.0)
    return {k: np.asarray(v) for k, v in get_state(m)[0].items()}


def _gpt(pkg, weights):
    if pkg == "jax":
        paddle.seed(3)
        return JaxGPT(**CFG, dropout=0.0)
    return load_numpy_state(GPTModel(**CFG, device="cpu"), weights)


def _fit_gpt(pkg, weights, tokens, accelerate, scheduled=True, **fit_kw):
    """``fit`` of the small GPT; returns (per-step losses, weights as the
    JAX names and layout, the Model)."""
    api, io, nn, O, L = PKG[pkg]
    net = _gpt(pkg, weights)
    params = list(net.parameters())
    lr = (L.LinearWarmup(L.CosineAnnealingDecay(LR, T_max=STEPS), 2, 0.0,
                         LR) if scheduled else LR)
    opt = O.AdamW(lr, parameters=params, weight_decay=WD,
                  grad_clip=(nn.ClipGradByGlobalNorm(1.0) if scheduled
                             else None))
    model = api.Model(net)
    model.prepare(opt, nn.CrossEntropyLoss(), accelerate=accelerate)
    losses = []

    class Record(api.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    np.random.seed(5)
    model.fit(io.DataLoader(io.TensorDataset(list(tokens)),
                            batch_size=BATCH, shuffle=True, drop_last=True),
              epochs=EPOCHS, verbose=0,
              callbacks=[Record(), api.callbacks.LRScheduler(by_step=True)],
              **fit_kw)
    if pkg == "jax":
        w = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    else:
        w = numpy_state(net)
    return losses, w, model


@pytest.fixture(scope="module")
def jax_eager(gpt_weights, tokens):
    return _fit_gpt("jax", gpt_weights, tokens, False)[:2]


@pytest.fixture(scope="module")
def jax_accelerated_constant(gpt_weights, tokens):
    return _fit_gpt("jax", gpt_weights, tokens, True, scheduled=False)[:2]


def _check_weights(got, want):
    """Every weight within ``2 · lr · steps``; the key bias's noise
    aside, at most 1 % of the entries beyond ``2e-3 · lr``."""
    assert set(got) == set(want)
    loose = total = 0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= 2 * LR * STEPS, (name, diff.max())
        if not name.endswith(NOISE):
            loose += int((diff > 2e-3 * LR).sum())
            total += diff.size
    assert loose <= 0.01 * total, f"{loose} of {total} entries off"


@pytest.mark.parametrize("accelerate", [True, False])
def test_gpt_fit_matches_jax_eager(accelerate, gpt_weights, tokens,
                                   jax_eager):
    want_l, want_w = jax_eager
    with compile_budget(None) as cb:
        got_l, got_w, _ = _fit_gpt("torch", gpt_weights, tokens, accelerate)
    assert len(got_l) == STEPS
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-4)
    _check_weights(got_w, want_w)
    assert got_l[-1] < got_l[0]
    # one signature: the running scheduler changes no signature
    assert cb.compiles() == ({"hapi/train_step": 1} if accelerate else {})


def test_gpt_graphed_and_eager_paths_are_bit_equal(gpt_weights, tokens):
    a_l, a_w, _ = _fit_gpt("torch", gpt_weights, tokens, True)
    e_l, e_w, _ = _fit_gpt("torch", gpt_weights, tokens, False)
    assert a_l == e_l
    for k in a_w:
        assert np.array_equal(a_w[k], e_w[k]), k


def test_gpt_fit_matches_jax_accelerated_at_constant_lr(
        gpt_weights, tokens, jax_accelerated_constant):
    want_l, want_w = jax_accelerated_constant
    got_l, got_w, _ = _fit_gpt("torch", gpt_weights, tokens, True,
                               scheduled=False)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-4)
    _check_weights(got_w, want_w)


def _jax_one_param_model(opt_of):
    paddle.seed(0)
    net = jnn.Linear(4, 1)
    model = paddle.Model(net)
    model.prepare(opt_of(net.parameters()), jnn.MSELoss(), accelerate=True)
    return model, net


def _port_one_param_model(opt_of):
    pt.seed(0)
    net = tnn.Linear(4, 1)
    model = pt.Model(net)
    model.prepare(opt_of(net.parameters()), tnn.MSELoss(), accelerate=True)
    return model, net


def _weight(model):
    """The trained weight (the JAX package's accelerated path donates
    the layer's buffers: read it through ``Model.state_dict``)."""
    return np.array(model.state_dict()["weight"].numpy())


def test_reference_accelerated_step_bakes_lr_and_drops_clip():
    """Reference behaviour, not a port fault: the JAX package's jitted
    step reads the LR at trace time (after ``PiecewiseDecay`` went to 0
    the second step still moves the weights) and skips ``grad_clip``
    (a 1e-6 global-norm clip still lets a step of ~lr·|g| through).  The
    port's graphed step applies the eager semantics: no move at LR 0, a
    clipped step moves at most lr·1e-6."""
    rng = np.random.RandomState(1)
    x = rng.randn(8, 4).astype(np.float32)
    y = (rng.randn(8, 1) + 5.0).astype(np.float32)
    for make, mod, O, L in (
            (_jax_one_param_model, jnn, jopt, jlr),
            (_port_one_param_model, tnn, topt, tlr)):
        model, _ = make(lambda ps: O.SGD(L.PiecewiseDecay([1], [0.1, 0.0]),
                                           parameters=ps))
        model.train_batch([x], [y])
        model._optimizer._lr.step()
        before = _weight(model)
        model.train_batch([x], [y])
        moved = np.abs(_weight(model) - before).max()
        if O is jopt:
            assert moved > 1e-2             # the baked LR 0.1 still applied
        else:
            assert moved == 0.0
        model, _ = make(lambda ps: O.SGD(
            0.1, parameters=ps, grad_clip=mod.ClipGradByGlobalNorm(1e-6)))
        before = _weight(model)
        model.train_batch([x], [y])
        moved = np.abs(_weight(model) - before).max()
        if O is jopt:
            assert moved > 1e-2             # the clip was dropped
        else:
            assert moved <= 0.1 * 1e-6 * 1.001


# --------------------------------------------------------------------------
# LeNet through the paddle-API Layer
# --------------------------------------------------------------------------
def _mnist_subset(pkg, n=64):
    ds = JaxMNIST(mode="train") if pkg == "jax" else MNIST(mode="train")
    return PKG[pkg][1].Subset(ds, list(range(n)))


@pytest.fixture(scope="module")
def lenet_ref():
    paddle.seed(0)
    net = JaxLeNet()
    state = {k: np.asarray(v._value) for k, v in net.state_dict().items()}
    model = paddle.Model(net)
    model.prepare(jopt.Adam(1e-3, parameters=net.parameters()),
                  jnn.CrossEntropyLoss(), jmetric.Accuracy(),
                  accelerate=False)
    losses = []

    class Record(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append((logs["loss"], logs["acc"]))

    model.fit(_mnist_subset("jax"), batch_size=32, shuffle=False, verbose=0,
              callbacks=[Record()])
    after = {k: np.asarray(v._value) for k, v in net.state_dict().items()}
    logs = model.evaluate(_mnist_subset("jax", 64), batch_size=32,
                          verbose=0)
    return state, losses, after, logs


def _port_lenet(state, accelerate):
    net = LeNet()
    assert net.set_state_dict(state_from_numpy(state, "cpu")) == ([], [])
    model = pt.Model(net)
    model.prepare(topt.Adam(1e-3, parameters=net.parameters()),
                  tnn.CrossEntropyLoss(), tmetric.Accuracy(),
                  accelerate=accelerate)
    return model, net


@pytest.mark.parametrize("accelerate", [True, False])
def test_lenet_fit_and_evaluate_match_jax(accelerate, lenet_ref):
    state, want, want_w, want_eval = lenet_ref
    model, net = _port_lenet(state, accelerate)
    got = []

    class Record(pt.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            got.append((logs["loss"], logs["acc"]))

    model.fit(_mnist_subset("torch"), batch_size=32, shuffle=False,
              verbose=0, callbacks=[Record()])
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-4)
    assert [g[1] for g in got] == [w[1] for w in want]
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_w[k], atol=2e-5, rtol=0)
    logs = model.evaluate(_mnist_subset("torch", 64), batch_size=32,
                          verbose=0)
    np.testing.assert_allclose(logs["loss"], want_eval["loss"], rtol=1e-4)
    assert logs["acc"] == want_eval["acc"]


def test_evaluate_predict_save_load_and_summary(lenet_ref, tmp_path):
    state = lenet_ref[0]
    model, net = _port_lenet(state, True)
    ds = _mnist_subset("torch", 8)
    x = np.stack([ds[i][0] for i in range(8)])
    with torch.no_grad():
        want = net(pt.to_tensor(x)).numpy()
    out = model.predict(ds, batch_size=4, stack_outputs=True)[0]
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(model.predict_batch([x])[0], want)
    res = model.eval_batch([x], [np.stack([ds[i][1] for i in range(8)])])
    assert len(res) == 2 and np.isfinite(res[0])
    model.fit(ds, batch_size=4, verbose=0)
    model.save(str(tmp_path / "ck"))
    other, onet = _port_lenet(state, False)
    other.load(str(tmp_path / "ck"))
    for k, v in net.state_dict().items():
        assert np.array_equal(onet.state_dict()[k].numpy(), v.numpy())
    sd = other._optimizer.state_dict()
    assert sd["step_count"] == 2
    for k, v in model._optimizer.state_dict().items():
        if k.startswith("param_"):
            assert torch.equal(sd[k], v)
    info = model.summary()
    paddle.seed(0)
    assert info == paddle.Model(JaxLeNet()).summary()
    assert info["total_params"] == sum(p.size for p in net.parameters())
    gpt = pt.Model(GPTModel(**CFG, device="cpu")).summary()
    assert gpt["total_params"] == sum(
        v.size for v in get_state(JaxGPT(**CFG, dropout=0.0))[0].values())


EVENTS = ("on_train_begin", "on_epoch_begin", "on_train_batch_begin",
          "on_train_batch_end", "on_epoch_end", "on_train_end",
          "on_eval_begin", "on_eval_end")


def _event_log(api, seen):
    class Log(api.callbacks.Callback):
        pass

    for name in EVENTS:
        def hook(self, *args, _name=name):
            seen.append(_name if not args or not isinstance(args[0], int)
                        else f"{_name}:{args[0]}")
        setattr(Log, name, hook)
    return Log()


def test_callbacks_fire_in_the_jax_order(gpt_weights, tokens, tmp_path):
    """The event order of ``fit`` (2 epochs, an eval set each epoch) and
    the shipped callbacks: ``ModelCheckpoint`` files, ``VisualDL`` TSV
    scalars, ``EarlyStopping`` and ``ReduceLROnPlateau`` acting."""
    order = {}
    for pkg in ("jax", "torch"):
        api, io = PKG[pkg][0], PKG[pkg][1]
        seen = []
        net = _gpt(pkg, gpt_weights)
        model = api.Model(net)
        model.prepare(PKG[pkg][3].SGD(0.1, parameters=net.parameters()),
                      PKG[pkg][2].CrossEntropyLoss())
        cb = [_event_log(api, seen),
              api.callbacks.ModelCheckpoint(1, str(tmp_path / pkg)),
              api.callbacks.VisualDL(str(tmp_path / f"{pkg}_vdl")),
              api.callbacks.EarlyStopping("loss", patience=5),
              api.callbacks.ReduceLROnPlateau("loss", patience=0,
                                              factor=0.5, verbose=0)]
        model.fit(io.TensorDataset(list(tokens)),
                  eval_data=io.TensorDataset(list(tokens)), batch_size=4,
                  epochs=2, shuffle=False, verbose=0, callbacks=cb)
        order[pkg] = (seen, model._optimizer.get_lr())
        assert (tmp_path / pkg / "1.pdparams").exists()
        assert (tmp_path / pkg / "final.pdparams").exists()
        assert (tmp_path / f"{pkg}_vdl" / "train_loss.tsv").exists()
    assert order["torch"] == order["jax"]
    assert "on_train_batch_end:1" in order["torch"][0]


def test_checkpointed_fit_resumes_bit_equal(gpt_weights, tokens, tmp_path):
    """A fit checkpointed every 2 steps and killed in step 4 (the
    ``train.step`` chaos site), resumed by a fresh Model from the newest
    checkpoint (step 2): its losses from step 3 on and its final weights
    equal the uninterrupted run's, bit for bit, on both paths."""
    from paddle_tpu_torch.framework.errors import FatalError
    from paddle_tpu_torch.testing import chaos

    for accelerate in (True, False):
        want_l, want_w, _ = _fit_gpt("torch", gpt_weights, tokens,
                                     accelerate)
        d = str(tmp_path / f"ck{accelerate}")
        with chaos.running(chaos.ChaosPlan([chaos.Fault("train.step", 4,
                                                        chaos.KILL)])):
            with pytest.raises(FatalError):
                _fit_gpt("torch", gpt_weights, tokens, accelerate,
                         checkpoint_dir=d, checkpoint_interval=2,
                         checkpoint_async=False)
        got_l, got_w, _ = _fit_gpt("torch", gpt_weights, tokens, accelerate,
                                   checkpoint_dir=d, checkpoint_interval=2,
                                   resume=True)
        assert got_l == want_l[2:]
        for k in want_w:
            assert np.array_equal(got_w[k], want_w[k]), k


def test_unported_options_raise():
    """What is not supported raises; ``amp_configs`` is accepted and
    ignored (as in the JAX package) and ``fit(anomaly=)`` runs, checked
    against the JAX package's own rule: rollback armed needs a
    ``checkpoint_dir``."""
    net = tnn.Linear(2, 2)
    model = pt.Model(net)
    model.prepare(topt.SGD(0.1, parameters=net.parameters()),
                  tnn.MSELoss(), amp_configs={"level": "O1"})
    jnet = jnn.Linear(2, 2)
    jmodel = paddle.Model(jnet)
    jmodel.prepare(jopt.SGD(0.1, parameters=jnet.parameters()),
                   jnn.MSELoss(), amp_configs={"level": "O1"})
    data = [np.zeros((2, 2), np.float32)] * 2
    for pkg, m, io in (("torch", model, tio), ("jax", jmodel, jio)):
        with pytest.raises(ValueError, match="checkpoint_dir"):
            m.fit(io.TensorDataset(data), anomaly=True, verbose=0)
    model.fit(tio.TensorDataset(data), batch_size=2, verbose=0,
              anomaly=pt.hapi.AnomalyPolicy(rollback_after=None))
    with pytest.raises(InvalidArgumentError, match="accelerate=False"):
        model.train_batch([np.zeros((2, 2), np.float32)],
                          [np.zeros((2, 2), np.float32)], update=False)
    from paddle_tpu_torch.hapi.model import StaticGraphAdapter

    # ported since: without InputSpecs it refuses, as the JAX package's
    with pytest.raises(ValueError, match="InputSpec"):
        StaticGraphAdapter(model)


# --- randomness in the train step --------------------------------------------
class _DropNet(tnn.Layer):
    """Embedding, one transformer encoder layer, a head over 50 ids."""

    def __init__(self, dropout):
        super().__init__()
        self.emb = tnn.Embedding(50, 32)
        self.enc = tnn.TransformerEncoderLayer(32, 2, 64, dropout=dropout)
        self.head = tnn.Linear(32, 50)

    def forward(self, x):
        return self.head(self.enc(self.emb(x)))


def _fit_drop(optim, dropout, accelerate, lr, seed=11, steps=3):
    """``steps`` train batches of one batch from ``pt.seed(seed)`` and
    fixed weights: (losses, weights)."""
    pt.seed(5)
    net = _DropNet(dropout)
    rng = np.random.RandomState(2)
    net.set_state_dict(state_from_numpy(
        {k: rng.randn(*v.shape).astype(np.float32) * 0.1
         for k, v in net.state_dict().items()}, "cpu"))
    opt = (topt.AdamW(lr, parameters=net.parameters(), weight_decay=0.1)
           if optim == "AdamW" else
           topt.Dpsgd(lr, clip=1.0, batch_size=4.0, sigma=0.5,
                      parameters=net.parameters()))
    model = pt.Model(net)
    model.prepare(opt, tnn.CrossEntropyLoss(), accelerate=accelerate)
    ids = rng.randint(0, 50, (2, 17))
    x, y = ids[:, :-1], ids[:, 1:]
    pt.seed(seed)
    losses = [model.train_batch([x], [y])[0] for _ in range(steps)]
    return losses, {k: v.numpy().copy() for k, v in net.state_dict().items()}


@pytest.mark.parametrize("case", ["flash", "plain", "dpsgd"])
def test_train_step_randomness_comes_from_the_port_generator(
        monkeypatch, case):
    if case == "flash":
        monkeypatch.setenv("PADDLE_TPU_FORCE_FLASH", "1")
    optim, dropout = ("Dpsgd", 0.0) if case == "dpsgd" else ("AdamW", 0.1)
    from paddle_tpu_torch.ops import attention as tatt

    tatt.ROUTE_STATS.update(pallas=0, xla=0)
    runs = [_fit_drop(optim, dropout, acc, 1e-2) for acc in (True, False)]
    assert tatt.ROUTE_STATS["pallas" if case == "flash" else "xla"] > 0
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        assert np.array_equal(runs[0][1][k], runs[1][1][k]), k
    if case == "dpsgd":
        other = _fit_drop(optim, dropout, True, 1e-2, seed=12)[1]
        assert not all(np.array_equal(other[k], runs[0][1][k])
                       for k in other)
    else:
        frozen = _fit_drop(optim, dropout, True, 0.0)[0]
        assert len(set(frozen)) == len(frozen), frozen
