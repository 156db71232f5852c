"""paddle_tpu_torch's paddle-API layers against the JAX package on the
same weights: the ops the sequence layers call (manipulation, creation,
indexing, activations), ``Identity``, ``Embedding``, ``Dropout``,
``LayerNorm``, the containers and every layer of ``nn/rnn.py``
(``tests/test_torch_transformer_layers.py`` holds ``nn/transformer.py``).

Each case builds the layer in both packages from one constructor call and
copies paddle_tpu's weights into the port; the ``state_dict`` names must
be equal, in order (``tests/torch_layer_parity.py``).  Tolerances:
forward 1e-5 absolute and relative, input and parameter gradients 1e-4
(the same f32 products on two backends, summed in another order; sizes
of at most 32).  Dropout draws its own bits in each package, so the
cases run it at p = 0 or in eval mode, and its keep rate is checked
statistically.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import creation as jcreation
from paddle_tpu.ops import manipulation as jmanip
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import creation as tcreation
from paddle_tpu_torch.ops import manipulation as tmanip
from torch_layer_parity import as_np as _np
from torch_layer_parity import build as _build
from torch_layer_parity import compare as _compare
from torch_layer_parity import one_torch_thread_on_the_cpu
from torch_layer_parity import rand as _x
from torch_layer_parity import rand_ids as _ids


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


# --- ops -------------------------------------------------------------------
def _op_cases():
    a, b = _x(2, 3, 4), _x(2, 3, 4, seed=1)
    return {
        "concat": (lambda m, x, y: m.concat([x, y], axis=1), [a, b]),
        "stack": (lambda m, x, y: m.stack([x, y], axis=-1), [a, b]),
        "transpose": (lambda m, x: m.transpose(x, [2, 0, 1]), [a]),
        "split_even": (lambda m, x: m.split(x, 2, axis=2), [a]),
        "split_sections": (lambda m, x: m.split(x, [1, -1], axis=1), [a]),
        "squeeze": (lambda m, x: m.squeeze(x, axis=[0, 2]),
                    [_x(1, 3, 1, 2)]),
        "squeeze_all": (lambda m, x: m.squeeze(x), [_x(1, 3, 1, 2)]),
        "unsqueeze": (lambda m, x: m.unsqueeze(x, [0, -1]), [a]),
        "expand": (lambda m, x: m.expand(x, [4, 2, -1, 4]),
                   [_x(2, 1, 4)]),
        "reshape": (lambda m, x: m.reshape(x, [3, 8]), [a]),
        "flatten": (lambda m, x: m.flatten(x, 1, 2), [a]),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_manipulation_ops(name):
    fn, inputs = _op_cases()[name]
    _compare(lambda *xs: fn(jmanip, *xs), lambda *xs: fn(tmanip, *xs),
             inputs, call=lambda f, *xs: f(*xs))


@pytest.mark.parametrize("index", [
    (slice(None), 1), 0, -1, (Ellipsis, 2), (None, slice(1, 3)),
    (slice(None, None, 2), slice(None), 1), "ids"],
    ids=["col", "row", "last", "ellipsis", "none", "step", "ids"])
def test_tensor_getitem(index):
    x = _x(4, 3, 5)
    ids = np.asarray([3, 0, 3], np.int64)

    def call(mod):
        def f(t):
            return t[mod.to_tensor(ids)] if index == "ids" else t[index]
        return f

    _compare(call(paddle), call(pt), [x], call=lambda f, *xs: f(*xs))


def test_tensor_methods_and_iteration():
    x = _x(3, 4)
    t = pt.to_tensor(x)
    np.testing.assert_array_equal(t.t().numpy(), x.T)
    np.testing.assert_array_equal(t.unsqueeze(0).squeeze(0).numpy(), x)
    np.testing.assert_array_equal(t.transpose([1, 0]).numpy(), x.T)
    assert [r.numpy().tolist() for r in t] == x.tolist()
    with pytest.raises(ValueError, match="ndim <= 2"):
        pt.to_tensor(_x(2, 2, 2)).t()


@pytest.mark.parametrize("name,args", [
    ("zeros", ([2, 3],)), ("ones", ([4],)), ("full", ([2, 2], 1.5)),
    ("full", ([3], 7, "int32")), ("arange", (5,)), ("arange", (1, 7, 2)),
    ("arange", (0.0, 1.0, 0.25)), ("arange", (2, 6, 1, "float32"))])
def test_creation_ops(name, args):
    j = getattr(jcreation, name)(*args)
    t = getattr(tcreation, name)(*args)
    np.testing.assert_array_equal(t.numpy(), _np(j))
    assert t.place.type == "cpu"


def test_creation_like_ops():
    x = _x(2, 3)
    for name, args in (("zeros_like", ()), ("full_like", (2.5,)),
                       ("full_like", (3, "int32"))):
        j = getattr(jcreation, name)(paddle.to_tensor(x), *args)
        t = getattr(tcreation, name)(pt.to_tensor(x), *args)
        np.testing.assert_array_equal(t.numpy(), _np(j))
        assert str(t.dtype).split(".")[-1] == str(_np(j).dtype)


@pytest.mark.parametrize("name,kw", [
    ("sigmoid", {}), ("tanh", {}), ("relu", {}), ("gelu", {}),
    ("softmax", {"axis": 1}), ("log_softmax", {}),
    ("softmax", {"axis": -1, "dtype": "float32"})])
def test_activations(name, kw):
    _compare(lambda x: getattr(JF, name)(x, **kw),
             lambda x: getattr(TF, name)(x, **kw), [_x(3, 5) * 3],
             call=lambda f, *xs: f(*xs))


# --- common layers, norms, containers --------------------------------------
LAYER_CASES = {
    "linear": (lambda m: m.Linear(6, 5), [_x(3, 6)]),
    "identity": (lambda m: m.Identity(7), [_x(3, 6)]),
    "embedding": (lambda m: m.Embedding(10, 6), [_ids(10, 3, 4)]),
    "embedding_pad": (lambda m: m.Embedding(10, 6, padding_idx=-2),
                      [np.asarray([[8, 1, 8], [0, 8, 9]], np.int64)]),
    "layer_norm": (lambda m: m.LayerNorm(6), [_x(3, 4, 6) * 2 + 1]),
    "layer_norm_2d": (lambda m: m.LayerNorm([4, 6], epsilon=1e-3),
                      [_x(3, 4, 6)]),
    "layer_norm_plain": (lambda m: m.LayerNorm(6, weight_attr=False,
                                               bias_attr=False),
                         [_x(2, 6)]),
    "dropout_p0": (lambda m: m.Dropout(0.0), [_x(3, 4)]),
    "sequential": (lambda m: m.Sequential(m.Linear(4, 5), m.ReLU(),
                                          m.Linear(5, 3)), [_x(2, 4)]),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_common_layers(name):
    factory, inputs = LAYER_CASES[name]
    jl, tl = _build(factory)
    _compare(jl, tl, inputs)


def test_embedding_padding_row_and_sparse_refusal():
    """The padding row starts at zero; ``sparse=True`` is no longer
    refused: the same rows, a row-sparse gradient
    (``tests/test_torch_sparse_grad.py`` holds it against the JAX
    package)."""
    from paddle_tpu_torch.sparse_grad import IndexedSlices

    _, tl = _build(lambda m: m.Embedding(5, 3, padding_idx=1))
    assert not tl.weight.numpy()[1].any()
    sp = tnn.Embedding(5, 3, sparse=True)
    sp.weight.set_value(tl.weight.numpy())
    ids = pt.to_tensor(np.asarray([1, 4, 4]))
    out = sp(ids)
    np.testing.assert_array_equal(out.numpy(), tl.weight.numpy()[[1, 4, 4]])
    out.sum().backward()
    assert isinstance(sp.weight.grad, IndexedSlices)


def test_dropout_eval_and_downscale_modes():
    x = _x(4, 5)
    for mode in ("upscale_in_train", "downscale_in_infer"):
        jl, tl = _build(lambda m: m.Dropout(0.4, mode=mode))
        jl.eval()
        tl.eval()
        _compare(jl, tl, [x])


@pytest.mark.parametrize("axis", [None, 1])
def test_dropout_keep_rate_is_statistical(axis):
    """p = 0.3: about 70 % kept (5 sigma of a binomial), each kept value
    scaled by 1/0.7, the rest 0; with ``axis`` one draw per slice."""
    pt.seed(5)
    x = np.ones((400, 500), np.float32)
    out = tnn.Dropout(0.3, axis=axis)(pt.to_tensor(x)).numpy()
    kept = out != 0
    n = kept.size if axis is None else kept.shape[1]
    rate = kept.mean()
    assert abs(rate - 0.7) < 5 * np.sqrt(0.21 / n), rate
    np.testing.assert_allclose(out[kept], 1 / 0.7, rtol=1e-6)
    if axis is not None:
        assert (kept == kept[:1]).all()


def test_containers_name_their_members_as_paddle():
    def factory(m):
        net = m.Layer()
        net.blocks = m.LayerList([m.Linear(2, 3), m.Linear(3, 2)])
        net.blocks.append(m.LayerNorm(2))
        net.heads = m.LayerDict({"a": m.Linear(2, 1), "b": m.Linear(2, 2)})
        net.extra = m.ParameterList([net.blocks[0].weight])
        return net

    jl, tl = _build(factory)
    assert len(tl.blocks) == 3 and list(tl.heads.keys()) == ["a", "b"]
    assert tl.blocks[-1] is tl.blocks[2] and "b" in tl.heads
    assert [p is q for p, q in zip(tl.extra, [tl.blocks[0].weight])] == [
        True]
    tl.heads.pop("a")
    assert list(tl.state_dict()) == [k for k in jl.state_dict()
                                     if not k.startswith("heads.a")]


# --- nn/rnn.py -------------------------------------------------------------
def _cell_call(states):
    def call(layer, x, *st):
        if not st:
            return layer(x)
        return layer(x, tuple(st) if len(st) > 1 else st[0])

    return call


RNN_CASES = {
    "simple_cell": (lambda m: m.SimpleRNNCell(5, 6), [_x(3, 5), _x(3, 6)],
                    1),
    "simple_cell_relu": (lambda m: m.SimpleRNNCell(5, 6, activation="relu"),
                         [_x(3, 5)], 0),
    "lstm_cell": (lambda m: m.LSTMCell(5, 6),
                  [_x(3, 5), _x(3, 6, seed=1), _x(3, 6, seed=2)], 2),
    "lstm_cell_zero": (lambda m: m.LSTMCell(5, 6), [_x(3, 5)], 0),
    "gru_cell": (lambda m: m.GRUCell(5, 6), [_x(3, 5), _x(3, 6, seed=1)], 1),
    "gru_cell_no_bias": (lambda m: m.GRUCell(5, 6, bias_ih_attr=False,
                                             bias_hh_attr=False),
                         [_x(3, 5)], 0),
}


@pytest.mark.parametrize("name", sorted(RNN_CASES))
def test_rnn_cells(name):
    factory, inputs, n_states = RNN_CASES[name]
    jl, tl = _build(factory)
    _compare(jl, tl, inputs, call=_cell_call(n_states))


SEQ_CASES = {
    "rnn_gru": lambda m: m.RNN(m.GRUCell(5, 6)),
    "rnn_lstm_reverse": lambda m: m.RNN(m.LSTMCell(5, 6), is_reverse=True),
    "rnn_time_major": lambda m: m.RNN(m.SimpleRNNCell(5, 6),
                                      time_major=True),  # [4, 3, 5]
    "birnn": lambda m: m.BiRNN(m.GRUCell(5, 6), m.GRUCell(5, 6)),
    "simple_rnn": lambda m: m.SimpleRNN(5, 6),
    "simple_rnn_relu_2layer": lambda m: m.SimpleRNN(5, 6, num_layers=2,
                                                    activation="relu"),
    "gru": lambda m: m.GRU(5, 6),
    "gru_bidirect_2layer": lambda m: m.GRU(5, 6, num_layers=2,
                                           direction="bidirect"),
    "lstm": lambda m: m.LSTM(5, 6),
    "lstm_bidirect_2layer": lambda m: m.LSTM(5, 6, num_layers=2,
                                             direction="bidirectional"),
    "lstm_time_major": lambda m: m.LSTM(5, 6, time_major=True),
}


@pytest.mark.parametrize("name", sorted(SEQ_CASES))
def test_sequence_rnns(name):
    jl, tl = _build(SEQ_CASES[name])
    _compare(jl, tl, [_x(3, 4, 5)])


def test_stacked_rnns_take_initial_states():
    x = _x(3, 4, 5)
    jl, tl = _build(lambda m: m.LSTM(5, 6, direction="bidirect"))
    h0, c0 = _x(2, 3, 6, seed=3), _x(2, 3, 6, seed=4)
    _compare(jl, tl, [x, h0, c0],
             call=lambda layer, xx, h, c: layer(xx, (h, c)))
    jl, tl = _build(lambda m: m.GRU(5, 6))
    _compare(jl, tl, [x, _x(1, 3, 6, seed=5)])


def test_state_dict_names_of_the_stacked_rnns():
    _, tl = _build(lambda m: m.LSTM(3, 4, num_layers=2, direction="bidirect"))
    assert list(tl.state_dict())[:5] == [
        "weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0",
        "weight_ih_l0_reverse"]
    assert tuple(tl.weight_ih_l1.shape) == (16, 8)


def test_sequence_length_raises():
    x = pt.to_tensor(_x(2, 3, 5))
    for layer in (tnn.LSTM(5, 4), tnn.RNN(tnn.GRUCell(5, 4)),
                  tnn.BiRNN(tnn.GRUCell(5, 4), tnn.GRUCell(5, 4))):
        with pytest.raises(InvalidArgumentError, match="item 8"):
            layer(x, sequence_length=pt.to_tensor(np.asarray([3, 2])))
