"""Row-sparse embedding gradients and the row-wise optimizer step of the
port against the JAX package's (``paddle_tpu/sparse_grad.py``, the cases
of ``tests/test_sparse_grad.py:30-124``), on the CPU with the same
weights:

- ``Embedding(sparse=True)``'s gradient is an ``IndexedSlices`` with one
  row per id of the batch; ``to_dense`` equals the dense path; duplicate
  ids merge into static slots; two backwards concatenate; the rows of
  ``padding_idx`` carry zeros; a sparse plus a dense gradient is dense;
- one step of every optimizer that has a row-wise step in the reference
  equals the reference's sparse step, equals the dense step on the
  touched rows and leaves the untouched rows bit-unchanged; ``lazy_mode``
  changes nothing; a parameter's learning-rate scale applies;
- ``AdamW(apply_decay_param_fun=)`` on the names of the reference's
  parameters; ``GradScaler`` unscales a sparse gradient's values;
  ``get_tensor_from_selected_rows``; the hapi step in both modes;
- a 50,000-row vocabulary trains, step for step as the reference.

Tolerances (f32): the gathers, merges and densifications exact; the
optimizer steps 1e-6 relative and 1e-7 absolute (the same expressions on
two backends; the absolute term for entries near zero), against the
reference's jitted hapi step 2e-5 absolute (XLA's summation order, as in
``tests/test_torch_hapi.py``); the trained losses 1e-5 relative (up to
15 Adam steps through a mean and a Linear)."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.sparse_grad import IndexedSlices as JSlices
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.sparse_grad import IndexedSlices as TSlices
from torch_layer_parity import build, one_torch_thread_on_the_cpu

STEP = dict(rtol=1e-6, atol=1e-7)
VOCAB, DIM = 64, 8
IDS = np.array([[1, 5, 7, 5], [2, 9, 5, 63]], np.int64)


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


def _emb(sparse=True, padding_idx=None, attr=None, seed=0):
    return build(lambda nn: nn.Embedding(
        VOCAB, DIM, padding_idx=padding_idx, sparse=sparse,
        weight_attr=None if attr is None else attr(nn)), seed=seed)


def _square_loss(layer, pkg, ids=IDS):
    out = layer(pkg.to_tensor(ids))
    w = np.linspace(-1.0, 1.0, out.size, dtype=np.float32).reshape(out.shape)
    return (out * out * pkg.to_tensor(w)).sum()


def _np(x):
    return np.asarray(x)


# --- the gradient ---------------------------------------------------------
def test_gradient_is_indexed_slices_with_one_row_per_id():
    jl, tl = _emb()
    _square_loss(jl, jp).backward()
    _square_loss(tl, pt).backward()
    jg, tg = jl.weight._grad, tl.weight.grad
    assert isinstance(jg, JSlices) and isinstance(tg, TSlices)
    assert tuple(tg.values.shape) == (IDS.size, DIM) == jg.values.shape
    assert tg.dense_shape == jg.dense_shape == (VOCAB, DIM)
    np.testing.assert_array_equal(tg.rows.numpy(), _np(jg.rows))
    np.testing.assert_array_equal(tg.values.numpy(), _np(jg.values))


@pytest.mark.parametrize("padding_idx", [None, 5, -1])
def test_to_dense_equals_the_dense_path(padding_idx):
    js, ts = _emb(padding_idx=padding_idx)
    jd, td = _emb(sparse=False, padding_idx=padding_idx)
    for layer, pkg in ((js, jp), (ts, pt), (jd, jp), (td, pt)):
        _square_loss(layer, pkg).backward()
    dense = ts.weight.grad.to_dense().numpy()
    np.testing.assert_array_equal(dense, _np(js.weight._grad.to_dense()))
    np.testing.assert_array_equal(dense, td.weight.grad.numpy())
    np.testing.assert_array_equal(dense, _np(jd.weight._grad._value))
    if padding_idx is not None:
        pad = padding_idx % VOCAB
        assert not dense[pad].any()
        rows = ts.weight.grad.rows.numpy()
        assert not ts.weight.grad.values.numpy()[rows == pad].any()


@pytest.mark.parametrize("rows", [[3, 1, 3, 1, 3], [0, 9, 9, 9], [4],
                                  [2, 7, 5, 0]])
def test_merged_sums_duplicates_into_static_slots(rows):
    import jax.numpy as jnp
    import torch

    vals = np.arange(len(rows) * 4, dtype=np.float32).reshape(-1, 4)
    jm = JSlices(jnp.asarray(rows, jnp.int32), jnp.asarray(vals),
                 (10, 4)).merged()
    tm = TSlices(torch.tensor(rows), torch.from_numpy(vals), (10, 4)).merged()
    assert tuple(tm.rows.shape) == (len(rows),)
    np.testing.assert_array_equal(tm.rows.numpy(), _np(jm.rows))
    np.testing.assert_array_equal(tm.values.numpy(), _np(jm.values))
    np.testing.assert_array_equal(tm.to_dense().numpy(),
                                  _np(jm.to_dense()))


def test_two_backwards_concatenate():
    jl, tl = _emb(seed=1)
    for layer, pkg in ((jl, jp), (tl, pt)):
        _square_loss(layer, pkg, IDS[:1]).backward()
        _square_loss(layer, pkg, IDS[1:]).backward()
    tg = tl.weight.grad
    assert isinstance(tg, TSlices) and tg.values.shape[0] == IDS.size
    np.testing.assert_array_equal(tg.to_dense().numpy(),
                                  _np(jl.weight._grad.to_dense()))


def test_sparse_plus_dense_gradient_is_dense():
    """A table read by a sparse lookup and by a dense product (tied
    weights): the two gradients sum into a dense one."""
    jl, tl = _emb(seed=2)
    grads = {}
    for name, layer, pkg in (("ref", jl, jp), ("port", tl, pt)):
        loss = _square_loss(layer, pkg) + (layer.weight * layer.weight).sum()
        loss.backward()
        g = layer.weight._grad if name == "ref" else layer.weight.grad
        assert isinstance(g, pkg.Tensor)
        grads[name] = np.asarray(g.numpy())
    np.testing.assert_allclose(grads["port"], grads["ref"], **STEP)


def test_get_tensor_from_selected_rows():
    jl, tl = _emb(seed=3)
    _square_loss(jl, jp).backward()
    _square_loss(tl, pt).backward()
    td = pt.get_tensor_from_selected_rows(tl.weight.grad)
    jd = jp.get_tensor_from_selected_rows(jl.weight._grad)
    assert isinstance(td, pt.Tensor)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd.numpy()))


# --- the row-wise step ----------------------------------------------------
OPTIMIZERS = {
    "SGD": ("SGD", {}),
    "Momentum": ("Momentum", {"momentum": 0.9}),
    "Momentum_nesterov": ("Momentum", {"momentum": 0.9,
                                       "use_nesterov": True}),
    "Adagrad": ("Adagrad", {}),
    "Adam": ("Adam", {}),
    "Adam_lazy": ("Adam", {"lazy_mode": True}),
    "AdamW": ("AdamW", {"weight_decay": 0.1}),
    "Adamax": ("Adamax", {}),
    "Adadelta": ("Adadelta", {}),
    "RMSProp": ("RMSProp", {}),
    "RMSProp_centered": ("RMSProp", {"centered": True, "momentum": 0.5}),
    "Lamb": ("Lamb", {}),
    "Lars": ("Lars", {}),
    "Ftrl": ("Ftrl", {"l1": 0.01, "l2": 0.01}),
}


def _steps(layer, pkg, cls, kwargs, n):
    opt = getattr(pkg.optimizer, cls)(learning_rate=0.1,
                                      parameters=layer.parameters(), **kwargs)
    for i in range(n):
        _square_loss(layer, pkg, IDS if i % 2 == 0 else IDS[::-1]).backward()
        opt.step()
        opt.clear_grad()
    return np.asarray(layer.weight.numpy())


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_rowwise_step_matches_the_reference(name):
    cls, kwargs = OPTIMIZERS[name]
    jl, tl = _emb(seed=4)
    w0 = np.asarray(tl.weight.numpy())
    ref = _steps(jl, jp, cls, kwargs, 2)
    port = _steps(tl, pt, cls, kwargs, 2)
    np.testing.assert_allclose(port, ref, **STEP)
    untouched = np.setdiff1d(np.arange(VOCAB), IDS)
    np.testing.assert_array_equal(port[untouched], w0[untouched])


@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "Adagrad",
                                  "RMSProp"])
def test_one_sparse_step_equals_the_dense_step_on_touched_rows(name):
    cls, kwargs = OPTIMIZERS[name]
    _, ts = _emb(seed=5)
    _, td = _emb(sparse=False, seed=5)
    w0 = np.asarray(ts.weight.numpy())
    sparse = _steps(ts, pt, cls, kwargs, 1)
    dense = _steps(td, pt, cls, kwargs, 1)
    touched = np.unique(IDS)
    np.testing.assert_allclose(sparse[touched], dense[touched], **STEP)
    untouched = np.setdiff1d(np.arange(VOCAB), IDS)
    np.testing.assert_array_equal(sparse[untouched], w0[untouched])


def test_parameter_learning_rate_scale_applies_on_the_rowwise_path():
    def attr(nn):
        return (jp if nn.__name__.startswith("paddle_tpu.") else pt
                ).ParamAttr(learning_rate=0.25)

    jl, tl = _emb(attr=attr, seed=6)
    ref = _steps(jl, jp, "Adam", {}, 2)
    port = _steps(tl, pt, "Adam", {}, 2)
    np.testing.assert_allclose(port, ref, **STEP)


def test_lr_ratio_stays_refused_and_lookahead_refuses_a_sparse_gradient():
    _, tl = _emb()
    with pytest.raises(InvalidArgumentError, match="lr_ratio"):
        pt.optimizer.AdamW(parameters=tl.parameters(), lr_ratio=lambda p: 1)
    inner = pt.optimizer.SGD(0.1, parameters=tl.parameters())
    look = pt.optimizer.Lookahead(inner, k=2)
    _square_loss(tl, pt).backward()
    with pytest.raises(InvalidArgumentError, match="Lookahead"):
        look.step()


def _mlp(nn):
    return nn.Sequential(nn.Linear(4, 6), nn.Tanh(), nn.Linear(6, 2))


@pytest.mark.parametrize("keep", ["weights", "biases"])
def test_adamw_apply_decay_param_fun_by_parameter_name(keep):
    """The port names its parameters as the reference does for the same
    layers, and ``apply_decay_param_fun`` decides the decay by name."""
    jp.Tensor._name_counter = pt.Parameter._name_counter = 100
    jl, tl = build(_mlp, seed=7)
    names = [p.name for p in tl.parameters()]
    assert names == [p.name for p in jl.parameters()]
    chosen = {p.name for p in tl.parameters()
              if (p.ndim == 2) == (keep == "weights")}
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    out = {}
    for name, layer, pkg in (("ref", jl, jp), ("port", tl, pt)):
        opt = pkg.optimizer.AdamW(
            learning_rate=0.1, weight_decay=0.5, parameters=layer.parameters(),
            apply_decay_param_fun=lambda n: n in chosen)
        for _ in range(2):
            (layer(pkg.to_tensor(x)) ** 2).sum().backward()
            opt.step()
            opt.clear_grad()
        out[name] = [np.asarray(p.numpy()) for p in layer.parameters()]
    for r, p in zip(out["ref"], out["port"]):
        np.testing.assert_allclose(p, r, **STEP)


def test_grad_scaler_unscales_the_sparse_values():
    jl, tl = _emb(seed=8)
    vals, weights = {}, {}
    for name, layer, pkg in (("ref", jl, jp), ("port", tl, pt)):
        opt = pkg.optimizer.Adam(0.1, parameters=layer.parameters())
        scaler = pkg.amp.GradScaler(init_loss_scaling=4.0)
        scaler.scale(_square_loss(layer, pkg)).backward()
        scaler.unscale_(opt)
        g = layer.weight._grad if name == "ref" else layer.weight.grad
        vals[name] = np.asarray(g.values)
        scaler.step(opt)
        scaler.update()
        weights[name] = np.asarray(layer.weight.numpy())
    np.testing.assert_allclose(vals["port"], vals["ref"], **STEP)
    np.testing.assert_allclose(weights["port"], weights["ref"], **STEP)


class _Bag:
    """Embedding(sparse) -> mean over the ids -> Linear: the chip phase's
    model at a small size."""

    def __init__(self, nn, vocab, dim):
        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.emb = nn.Embedding(vocab, dim, sparse=True)
                self.head = nn.Linear(dim, 2)

            def forward(self, ids):
                return self.head(self.emb(ids).mean(axis=1))

        self.net = Net()


@pytest.mark.parametrize("accelerate", [True, False])
def test_hapi_step_over_a_sparse_embedding(accelerate):
    """The graphed step differentiates the lookup densely and takes the
    dense update, as the reference's jitted step; the eager step takes the
    row-wise one, as the reference's eager step."""
    jl, tl = build(lambda nn: _Bag(nn, VOCAB, DIM).net, seed=9)
    y = np.array([0, 1], np.int64)
    batches = [IDS, IDS + 1, IDS // 2]   # rows the later steps leave out
    out = {}
    for name, net, pkg in (("ref", jl, jp), ("port", tl, pt)):
        model = pkg.Model(net)
        model.prepare(pkg.optimizer.Adam(0.05, parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss(), accelerate=accelerate)
        losses = [float(np.asarray(model.train_batch(
            [pkg.to_tensor(ids % VOCAB)], [pkg.to_tensor(y)])[0]).reshape(-1)[0])
            for ids in batches]
        table = model.state_dict()["emb.weight"]
        out[name] = (losses, np.asarray(table.numpy()))
    np.testing.assert_allclose(out["port"][0], out["ref"][0], rtol=1e-5)
    # the reference's jitted step sums in XLA's order: its weights are
    # held within 2e-5, as in tests/test_torch_hapi.py; a row-sparse
    # update in its place would miss by the dense update's 1e-2
    tol = dict(atol=2e-5, rtol=0) if accelerate else STEP
    np.testing.assert_allclose(out["port"][1], out["ref"][1], **tol)


def test_large_vocab_trains_as_the_reference():
    """50,000 rows: 15 Adam steps, the port's losses step for step the
    reference's, falling by half."""
    jl, tl = build(lambda nn: _Bag(nn, 50_000, 32).net, seed=0)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 50_000, (16, 4)).astype(np.int64)
    y = rng.randint(0, 2, (16,)).astype(np.int64)
    losses = {}
    for name, net, pkg in (("ref", jl, jp), ("port", tl, pt)):
        opt = pkg.optimizer.Adam(learning_rate=0.05,
                                 parameters=net.parameters())
        loss_fn = pkg.nn.CrossEntropyLoss()
        seq = []
        for _ in range(15):
            loss = loss_fn(net(pkg.to_tensor(ids)), pkg.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            seq.append(float(np.asarray(loss.numpy())))
        losses[name] = seq
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5)
    assert losses["port"][-1] < losses["port"][0] * 0.5


@pytest.mark.parametrize("padding_idx", [None, 5])
def test_embedding_sparse_vjp_and_add(padding_idx):
    """The lookup's weight cotangent as (ids, rows), padding rows zeroed;
    slices plus slices concatenate, plus a dense array densify."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu.sparse_grad import embedding_sparse_vjp as jvjp
    from paddle_tpu_torch.sparse_grad import embedding_sparse_vjp as tvjp

    ct = np.random.RandomState(0).randn(*IDS.shape, DIM).astype(np.float32)
    jr, jv = jvjp(jnp.asarray(IDS), VOCAB, padding_idx)(jnp.asarray(ct))
    tr, tv = tvjp(torch.from_numpy(IDS), VOCAB, padding_idx)(
        torch.from_numpy(ct))
    np.testing.assert_array_equal(tr.numpy(), _np(jr))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    js, ts = JSlices(jr, jv, (VOCAB, DIM)), TSlices(tr, tv, (VOCAB, DIM))
    np.testing.assert_array_equal(ts.add(ts).to_dense().numpy(),
                                  _np(js.add(js).to_dense()))
    dense = np.ones((VOCAB, DIM), np.float32)
    np.testing.assert_array_equal(
        ts.add(torch.from_numpy(dense)).numpy(),
        _np(js.add(jnp.asarray(dense))))
