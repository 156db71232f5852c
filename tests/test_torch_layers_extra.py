"""``nn/layers_extra.py`` and the two functionals it needs
(``nn/functional/extension.py``'s ``hsigmoid_loss`` and ``nce``) against
the JAX package's, on the same seeded inputs and weights, and the rest
of ``nn``'s namespace (the reference's re-exports).

- ``PairwiseDistance``, ``HSigmoidLoss`` and ``TreeConv``: forward within
  1e-5, gradients within 1e-4 (``tests/torch_layer_parity.py``);
- ``ctc_greedy_decoder``: exact (index work);
- ``nce`` draws its negatives from the port's generator: it equals the
  reference exactly where the draw does not matter — one class (every
  negative is class 0) and no negatives (the reference's ``log(0/K)``
  gives NaN there, and so does the port's) — and in distribution
  otherwise: the mean loss over 4,000 rows within five standard errors
  of its exact expectation;
- ``DynamicRNN`` / ``StaticRNN`` raise on ``block()`` as the reference's;
  the knobs the reference accepts and never reads raise."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu.nn.functional import extension as jext
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.nn.functional import extension as text
from torch_layer_parity import as_np, build, compare, one_torch_thread_on_the_cpu
from torch_layer_parity import rand as _x

F32 = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


def _edges():
    """Two trees over 5 nodes, (parent, child) pairs, zero-padded."""
    return np.array([[[0, 1], [0, 2], [1, 3], [1, 4]],
                     [[0, 1], [1, 2], [2, 3], [0, 0]]], np.int64)


LAYERS = {
    "PairwiseDistance": (lambda nn: nn.PairwiseDistance(),
                         [_x(4, 6), _x(4, 6, seed=1)]),
    "PairwiseDistance_p1_keepdim": (
        lambda nn: nn.PairwiseDistance(p=1.0, keepdim=True),
        [_x(3, 2, 5), _x(3, 2, 5, seed=1)]),
    "HSigmoidLoss": (lambda nn: nn.HSigmoidLoss(6, 7),
                     [_x(5, 6), np.array([0, 3, 6, 2, 5], np.int64)]),
    "HSigmoidLoss_no_bias": (lambda nn: nn.HSigmoidLoss(4, 2,
                                                        bias_attr=False),
                             [_x(3, 4), np.array([0, 1, 1], np.int64)]),
    "TreeConv": (lambda nn: nn.TreeConv(4, 3, num_filters=2, max_depth=3),
                 [_x(2, 5, 4), _edges()]),
    "TreeConv_no_act": (lambda nn: nn.TreeConv(4, 2, act=None),
                        [_x(2, 5, 4), _edges()]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    factory, inputs = LAYERS[name]
    jl, tl = build(factory)
    compare(jl, tl, inputs)


@pytest.mark.parametrize("lengths", [None, [5, 3, 0]])
def test_ctc_greedy_decoder(lengths):
    scores = _x(3, 5, 4, seed=3)
    scores[0, 1] = scores[0, 0]             # a repeat to collapse
    outs = {}
    for name, pkg in (("ref", jp), ("port", pt)):
        args = [pkg.to_tensor(scores), 0]
        kw = {} if lengths is None else {
            "input_length": pkg.to_tensor(np.array(lengths, np.int64))}
        ids, n = pkg.nn.ctc_greedy_decoder(*args, padding_value=-1, **kw)
        outs[name] = (np.asarray(ids.numpy()), np.asarray(n.numpy()))
    for r, p in zip(outs["ref"], outs["port"]):
        assert p.dtype == np.int64
        np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("cls", ["DynamicRNN", "StaticRNN"])
def test_fluid_rnn_builders_raise(cls):
    for pkg in (jp, pt):
        rnn = getattr(pkg.nn, cls)()
        with pytest.raises(NotImplementedError, match="nn.RNN"):
            rnn.block()
        with pytest.raises(NotImplementedError):
            rnn.step()


def _nce_both(k, s, rows=4, dim=6):
    x, w, b = _x(rows, dim), _x(k, dim, seed=1), _x(k, seed=2)
    y = np.random.RandomState(3).randint(0, k, rows).astype(np.int64)
    out = {}
    for name, pkg, mod in (("ref", jp, jext), ("port", pt, text)):
        xt = pkg.to_tensor(x, stop_gradient=False)
        wt = pkg.to_tensor(w, stop_gradient=False)
        bt = pkg.to_tensor(b, stop_gradient=False)
        loss = mod.nce(xt, pkg.to_tensor(y), k, num_neg_samples=s,
                       weight=wt, bias=bt)
        out[name] = [loss, xt, wt, bt]
    return out


@pytest.mark.parametrize("k,s", [(1, 3), (1, 1), (5, 0)])
def test_nce_where_the_draw_does_not_matter(k, s):
    out = _nce_both(k, s)
    np.testing.assert_allclose(as_np(out["port"][0]), as_np(out["ref"][0]),
                               **F32)
    if s == 0:
        assert np.isnan(as_np(out["port"][0])).all()
        return
    for name in ("ref", "port"):
        out[name][0].sum().backward()
    for j, t in zip(out["ref"][1:], out["port"][1:]):
        np.testing.assert_allclose(as_np(t.grad), as_np(j.grad), **F32)


def test_nce_loss_layer_statistics():
    """4,000 copies of one row: the mean loss within five standard errors
    of the exact expectation over uniform negatives."""
    k, s, n = 6, 4, 4000
    pt.seed(11)
    layer = pt.nn.NCELoss(5, k, num_neg_samples=s)
    x = np.repeat(_x(1, 5, seed=4), n, axis=0)
    y = np.full((n,), 2, np.int64)
    loss = layer(pt.to_tensor(x), pt.to_tensor(y)).numpy().ravel()
    w, b = layer.weight.numpy(), layer.bias.numpy()
    logit = x[0] @ w.T + b - np.log(s / k)

    def xent(z, t):
        return np.log1p(np.exp(-np.abs(z))) + np.maximum(z, 0) - z * t

    neg = xent(logit, 0.0)
    mean = xent(logit[2], 1.0) + s * neg.mean()
    se = np.sqrt(s * neg.var() / n)
    assert abs(loss.mean() - mean) < 5 * se + 1e-6


def test_knobs_the_reference_never_reads_raise():
    x, y = pt.to_tensor(_x(2, 4)), pt.to_tensor(np.array([0, 1], np.int64))
    w = pt.to_tensor(_x(3, 4))
    for kw in ({"sampler": "log_uniform"}, {"custom_dist": [0.5, 0.5, 0.0]},
               {"seed": 5}, {"is_sparse": True},
               {"sample_weight": pt.to_tensor(_x(2, 1))}):
        with pytest.raises(InvalidArgumentError):
            text.nce(x, y, 3, weight=w, **kw)
    for kw in ({"path_table": pt.to_tensor(np.zeros((2, 2), np.int64))},
               {"path_code": pt.to_tensor(np.zeros((2, 2), np.int64))},
               {"is_sparse": True}):
        with pytest.raises(InvalidArgumentError):
            text.hsigmoid_loss(x, y, 3, w[:2], **kw)
    with pytest.raises(InvalidArgumentError):
        pt.nn.HSigmoidLoss(4, 3, is_custom=True)


def test_hsigmoid_loss_functional():
    x, w, b = _x(4, 5), _x(6, 5, seed=1), _x(6, seed=2)
    y = np.array([0, 6, 3, 5], np.int64)
    out = {}
    for name, pkg, mod in (("ref", jp, jext), ("port", pt, text)):
        ts = [pkg.to_tensor(a, stop_gradient=False) for a in (x, w, b)]
        loss = mod.hsigmoid_loss(ts[0], pkg.to_tensor(y), 7, ts[1],
                                 bias=ts[2])
        loss.sum().backward()
        out[name] = [loss] + [t.grad for t in ts]
    for j, t in zip(out["ref"], out["port"]):
        np.testing.assert_allclose(as_np(t), as_np(j), **F32)


NN_NAMES = ["common", "conv", "extension", "loss", "norm", "weight_norm_hook",
            "RNNCellBase", "Decoder", "PairwiseDistance", "HSigmoidLoss",
            "NCELoss", "TreeConv", "ctc_greedy_decoder", "DynamicRNN",
            "StaticRNN"]


@pytest.mark.parametrize("name", NN_NAMES)
def test_nn_reexports(name):
    port = getattr(pt.nn, name)
    ref = getattr(jp.nn, name)
    assert type(port).__name__ == type(ref).__name__
    if isinstance(ref, type):
        assert port.__name__ == ref.__name__
    if name in ("common", "conv", "loss", "norm", "weight_norm_hook"):
        assert port.__name__.split(".")[-1] == ref.__name__.split(".")[-1]
