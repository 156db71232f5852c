"""paddle_tpu_torch's convolutions, pools and activations against the JAX
package on the same seeded numpy inputs and weights:

- ``conv1d/2d/3d`` and their transposes in channel-first and
  channel-last layouts, with groups, dilation, strides, ``"SAME"`` /
  ``"VALID"`` and asymmetric padding, and ``output_padding``; the conv
  layers of ``nn/conv_layers.py`` (names, forward, gradients), a
  channel-last ``Conv2D``'s weight in ``channels_last`` memory;
  ``deformable_conv`` v1 and v2;
- every pool of ``nn/functional/pooling.py`` in both layouts, with
  ``exclusive`` on and off, padding ATen takes as it is and padding it
  does not, adaptive pooling at sizes that do not divide,
  ``max_pool2d(return_mask=True)`` and ``max_unpool2d``; the pool
  layers;
- every activation function and layer.

Tolerances (f32): forward 1e-5 and gradients 1e-4 absolute and relative
(``tests/torch_layer_parity.py``); the convolutions sum at most a few
hundred products per output, in another order on each backend.
Differences by design, checked on the port alone: ``ceil_mode=True``
raises, ``divisor_override`` divides (the JAX package ignores both).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch import nn as tnn
from torch_layer_parity import FWD, GRAD, as_np
from torch_layer_parity import build as _build
from torch_layer_parity import compare as _compare
from torch_layer_parity import one_torch_thread_on_the_cpu
from torch_layer_parity import rand as _x


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


def _both(fn, arrays, grad=True):
    """``fn(F, *tensors)`` in both packages on the same arrays: the
    outputs within FWD and, for float inputs, the gradients of the same
    weighted sum within GRAD."""
    jx = [paddle.to_tensor(a, stop_gradient=not grad) for a in arrays]
    tx = [pt.to_tensor(a, stop_gradient=not grad) for a in arrays]
    jo, to = fn(JF, *jx), fn(TF, *tx)
    jo = list(jo) if isinstance(jo, tuple) else [jo]
    to = list(to) if isinstance(to, tuple) else [to]
    for j, t in zip(jo, to):
        assert j.shape == t.shape
        np.testing.assert_allclose(as_np(t), as_np(j), **FWD)
    if not grad:
        return to
    w = _x(*jo[0].shape, seed=99)
    (jo[0] * paddle.to_tensor(w)).sum().backward()
    (to[0] * pt.to_tensor(w)).sum().backward()
    for j, t in zip(jx, tx):
        np.testing.assert_allclose(as_np(t.grad), as_np(j.grad), **GRAD)
    return to


def _cl(shape):
    """A channel-first shape moved to channel-last."""
    return (shape[0],) + tuple(shape[2:]) + (shape[1],)


# --- convolutions ----------------------------------------------------------
# name: (n, x shape (channel-first), weight shape, kwargs)
CONVS = {
    "1d": (1, (2, 4, 11), (6, 4, 3), dict(stride=2, padding=1)),
    "1d_same_dilated": (1, (2, 4, 11), (6, 2, 3),
                        dict(padding="SAME", dilation=2, groups=2)),
    "2d": (2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding=1)),
    "2d_stride_groups": (2, (2, 4, 9, 8), (8, 2, 3, 3),
                         dict(stride=2, padding=[1, 0], groups=2)),
    "2d_same_stride": (2, (2, 3, 9, 8), (4, 3, 3, 3),
                       dict(stride=2, padding="SAME")),
    "2d_valid_dilated": (2, (2, 3, 9, 8), (4, 3, 3, 2),
                         dict(padding="VALID", dilation=2)),
    "2d_asymmetric": (2, (2, 3, 7, 7), (4, 3, 3, 3),
                      dict(padding=[0, 2, 1, 0])),
    "2d_depthwise": (2, (2, 4, 6, 6), (4, 1, 3, 3),
                     dict(padding=1, groups=4)),
    "3d": (3, (1, 2, 5, 5, 4), (3, 2, 3, 3, 2), dict(padding=1)),
}


@pytest.mark.parametrize("layout", ["first", "last"])
@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv_matches_jax(case, layout):
    n, xs, ws, kw = CONVS[case]
    fmt = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"),
           3: ("NCDHW", "NDHWC")}[n][layout == "last"]
    x = _x(*(xs if layout == "first" else _cl(xs)), seed=1)
    w, b = _x(*ws, seed=2), _x(ws[0], seed=3)
    fn_name = f"conv{n}d"
    _both(lambda F, xx, ww, bb: getattr(F, fn_name)(
        xx, ww, bb, data_format=fmt, **kw), [x, w, b])


# name: (n, x shape (channel-first), weight shape [in, out/g, *k], kwargs)
CONV_TS = {
    "1d": (1, (2, 4, 6), (4, 3, 3), dict(stride=2, padding=1)),
    "2d": (2, (2, 4, 5, 4), (4, 3, 3, 3), dict(stride=2, padding=1,
                                                output_padding=1)),
    "2d_groups_dilated": (2, (2, 4, 5, 5), (4, 2, 3, 2),
                          dict(groups=2, dilation=2, padding=[1, 0])),
    "2d_same": (2, (2, 3, 4, 5), (3, 2, 4, 4), dict(stride=2,
                                                    padding="SAME")),
    "2d_asymmetric": (2, (2, 3, 4, 4), (3, 2, 3, 3),
                      dict(stride=2, padding=[0, 1, 1, 0])),
    "3d": (3, (1, 2, 3, 3, 3), (2, 3, 2, 2, 2), dict(stride=2)),
}


@pytest.mark.parametrize("layout", ["first", "last"])
@pytest.mark.parametrize("case", sorted(CONV_TS))
def test_conv_transpose_matches_jax(case, layout):
    n, xs, ws, kw = CONV_TS[case]
    fmt = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"),
           3: ("NCDHW", "NDHWC")}[n][layout == "last"]
    x = _x(*(xs if layout == "first" else _cl(xs)), seed=4)
    w = _x(*ws, seed=5)
    b = _x(ws[1] * kw.get("groups", 1), seed=6)
    fn_name = f"conv{n}d_transpose"
    _both(lambda F, xx, ww, bb: getattr(F, fn_name)(
        xx, ww, bb, data_format=fmt, **kw), [x, w, b])


CONV_LAYERS = {
    "Conv1D": (lambda m: m.Conv1D(3, 4, 3, padding=1), (2, 3, 7)),
    "Conv2D_nhwc": (lambda m: m.Conv2D(3, 4, 3, stride=2, padding=1,
                                       data_format="NHWC"), (2, 7, 7, 3)),
    "Conv2D_groups_no_bias": (lambda m: m.Conv2D(4, 4, 3, groups=2,
                                                 bias_attr=False),
                              (2, 4, 6, 6)),
    "Conv3D": (lambda m: m.Conv3D(2, 3, 2), (1, 2, 4, 4, 3)),
    "Conv2DTranspose": (lambda m: m.Conv2DTranspose(3, 4, 3, stride=2),
                        (2, 3, 4, 4)),
    "Conv1DTranspose": (lambda m: m.Conv1DTranspose(3, 2, 3, padding=1),
                        (2, 3, 5)),
    "Conv3DTranspose": (lambda m: m.Conv3DTranspose(2, 2, 2, stride=2),
                        (1, 2, 2, 3, 2)),
}


@pytest.mark.parametrize("case", sorted(CONV_LAYERS))
def test_conv_layers_match_jax(case):
    factory, shape = CONV_LAYERS[case]
    jl, tl = _build(factory)
    _compare(jl, tl, [_x(*shape, seed=7)])


def test_channel_last_conv2d_weight_is_channels_last():
    conv = tnn.Conv2D(3, 8, 3, data_format="NHWC")
    w = conv.weight._value
    assert w.shape == (8, 3, 3, 3) and w.is_leaf and w.requires_grad
    assert w.is_contiguous(memory_format=torch.channels_last)
    conv.set_state_dict({"weight": _x(8, 3, 3, 3), "bias": _x(8)})
    assert conv.weight._value.is_contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_deformable_conv_matches_jax(modulated):
    x = _x(1, 4, 5, 5, seed=8)
    offset = _x(1, 2 * 2 * 9, 5, 5, seed=9) * 0.7
    mask = np.abs(_x(1, 2 * 9, 5, 5, seed=10)) if modulated else None
    w, b = _x(6, 2, 3, 3, seed=11), _x(6, seed=12)

    def fn(F, xx, oo, ww, bb, *mm):
        return F.deformable_conv(xx, oo, mm[0] if mm else None, ww, bb,
                                 padding=1, deformable_groups=2, groups=2)

    _both(fn, [x, offset, w, b] + ([mask] if modulated else []))


# --- pools --------------------------------------------------------------------
POOLS = {
    "max1d": (lambda F, x, fmt: F.max_pool1d(x, 3, 2, 1, data_format=fmt),
              (2, 3, 9)),
    "max2d": (lambda F, x, fmt: F.max_pool2d(x, 3, 2, 1, data_format=fmt),
              (2, 3, 9, 8)),
    "max2d_same": (lambda F, x, fmt: F.max_pool2d(
        x, 3, 2, "SAME", data_format=fmt), (2, 3, 8, 7)),
    "max2d_wide_pad": (lambda F, x, fmt: F.max_pool2d(
        x, 2, 1, [2, 0, 1, 1], data_format=fmt), (2, 3, 5, 5)),
    "max3d": (lambda F, x, fmt: F.max_pool3d(x, 2, 2, data_format=fmt),
              (1, 2, 4, 5, 4)),
    "avg1d": (lambda F, x, fmt: F.avg_pool1d(x, 3, 2, 1, data_format=fmt),
              (2, 3, 9)),
    "avg2d_exclusive": (lambda F, x, fmt: F.avg_pool2d(
        x, 3, 2, 1, data_format=fmt), (2, 3, 9, 8)),
    "avg2d_inclusive": (lambda F, x, fmt: F.avg_pool2d(
        x, 3, 2, 1, exclusive=False, data_format=fmt), (2, 3, 9, 8)),
    "avg2d_asymmetric": (lambda F, x, fmt: F.avg_pool2d(
        x, 3, 1, [0, 2, 1, 1], data_format=fmt), (2, 3, 6, 6)),
    "avg2d_asymmetric_inclusive": (lambda F, x, fmt: F.avg_pool2d(
        x, 3, 1, [0, 2, 1, 1], exclusive=False, data_format=fmt),
        (2, 3, 6, 6)),
    "avg3d": (lambda F, x, fmt: F.avg_pool3d(x, 2, 1, 1, data_format=fmt),
              (1, 2, 3, 4, 3)),
    "adaptive_avg1d": (lambda F, x, fmt: F.adaptive_avg_pool1d(x, 4),
                       (2, 3, 10)),
    "adaptive_avg2d": (lambda F, x, fmt: F.adaptive_avg_pool2d(
        x, (3, 5), data_format=fmt), (2, 3, 7, 9)),
    "adaptive_avg2d_one": (lambda F, x, fmt: F.adaptive_avg_pool2d(
        x, 1, data_format=fmt), (2, 3, 5, 5)),
    "adaptive_avg2d_grow": (lambda F, x, fmt: F.adaptive_avg_pool2d(
        x, (7, 7), data_format=fmt), (2, 3, 2, 3)),
    "adaptive_avg3d": (lambda F, x, fmt: F.adaptive_avg_pool3d(
        x, (2, 3, 2), data_format=fmt), (1, 2, 5, 7, 3)),
    "adaptive_max1d": (lambda F, x, fmt: F.adaptive_max_pool1d(x, 3),
                       (2, 3, 10)),
    "adaptive_max2d": (lambda F, x, fmt: F.adaptive_max_pool2d(x, (3, 4)),
                       (2, 3, 7, 9)),
    "adaptive_max3d": (lambda F, x, fmt: F.adaptive_max_pool3d(x, 2),
                       (1, 2, 5, 5, 3)),
}
_CHANNEL_LAST = {1: "NLC", 2: "NHWC", 3: "NDHWC"}
_CHANNEL_FIRST = {1: "NCL", 2: "NCHW", 3: "NCDHW"}


# the adaptive max pools and the 1-D adaptive average pool take no
# data_format in either package
POOL_CASES = [(case, layout) for case in sorted(POOLS)
              for layout in ("first", "last")
              if layout == "first" or not (case.startswith("adaptive_max")
                                           or case == "adaptive_avg1d")]


@pytest.mark.parametrize("case,layout", POOL_CASES)
def test_pools_match_jax(case, layout):
    fn, shape = POOLS[case]
    n = len(shape) - 2
    fmt = (_CHANNEL_LAST if layout == "last" else _CHANNEL_FIRST)[n]
    x = _x(*(shape if layout == "first" else _cl(shape)), seed=13)
    _both(lambda F, xx: fn(F, xx, fmt), [x])


@pytest.mark.parametrize("padding", [0, 1, [1, 0, 0, 1]],
                         ids=["p0", "p1", "asym"])
def test_max_pool2d_mask_and_unpool_match_jax(padding):
    x = _x(2, 3, 6, 7, seed=14)
    out = _both(lambda F, xx: F.max_pool2d(xx, 2, 2, padding,
                                           return_mask=True), [x])
    assert out[1].dtype == torch.int32
    if padding == 0:
        j_out, j_idx = JF.max_pool2d(paddle.to_tensor(x), 2, 2,
                                     return_mask=True)
        jo = JF.max_unpool2d(j_out, j_idx, 2, 2, output_size=(6, 7))
        to = TF.max_unpool2d(out[0], out[1], 2, 2, output_size=(6, 7))
        np.testing.assert_allclose(as_np(to), as_np(jo), **FWD)


def test_max_pool2d_mask_channel_last_indexes_each_channel():
    """The port's NHWC mask: channel-last, each entry ``h·W + w`` of the
    maximum within its channel (the JAX package reads NHWC data as NCHW
    there: a difference by design)."""
    x = _x(2, 6, 7, 3, seed=15)
    out, idx = TF.max_pool2d(pt.to_tensor(x), 2, 2, return_mask=True,
                             data_format="NHWC")
    ref_out, ref_idx = TF.max_pool2d(
        pt.to_tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), 2, 2,
        return_mask=True)
    np.testing.assert_array_equal(as_np(out),
                                  as_np(ref_out).transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(as_np(idx),
                                  as_np(ref_idx).transpose(0, 2, 3, 1))


def test_pool_differences_by_design():
    x = pt.to_tensor(_x(1, 1, 4, 4, seed=16))
    with pytest.raises(InvalidArgumentError):
        TF.max_pool2d(x, 2, ceil_mode=True)
    with pytest.raises(InvalidArgumentError):
        TF.max_pool1d(pt.to_tensor(_x(1, 1, 4)), 2, return_mask=True)
    out = TF.avg_pool2d(x, 2, 2, divisor_override=3)
    want = as_np(x).reshape(1, 1, 2, 2, 2, 2).sum((3, 5)) / 3.0
    np.testing.assert_allclose(as_np(out), want, rtol=1e-6)


POOL_LAYERS = {
    "MaxPool1D": (lambda m: m.MaxPool1D(2, 2), (2, 3, 8)),
    "MaxPool2D_nhwc": (lambda m: m.MaxPool2D(3, 2, 1, data_format="NHWC"),
                       (2, 7, 7, 3)),
    "MaxPool3D": (lambda m: m.MaxPool3D(2, 2), (1, 2, 4, 4, 4)),
    "AvgPool1D": (lambda m: m.AvgPool1D(3, 1, 1), (2, 3, 8)),
    "AvgPool2D": (lambda m: m.AvgPool2D(2, 2, exclusive=False),
                  (2, 3, 6, 6)),
    "AvgPool3D": (lambda m: m.AvgPool3D(2, 2), (1, 2, 4, 4, 4)),
    "AdaptiveAvgPool1D": (lambda m: m.AdaptiveAvgPool1D(3), (2, 3, 7)),
    "AdaptiveAvgPool2D_nhwc": (lambda m: m.AdaptiveAvgPool2D(
        (1, 1), data_format="NHWC"), (2, 5, 5, 3)),
    "AdaptiveAvgPool3D": (lambda m: m.AdaptiveAvgPool3D(2),
                          (1, 2, 5, 4, 3)),
    "AdaptiveMaxPool1D": (lambda m: m.AdaptiveMaxPool1D(3), (2, 3, 7)),
    "AdaptiveMaxPool2D": (lambda m: m.AdaptiveMaxPool2D(3), (2, 3, 7, 5)),
    "AdaptiveMaxPool3D": (lambda m: m.AdaptiveMaxPool3D(2),
                          (1, 2, 5, 4, 3)),
}


@pytest.mark.parametrize("case", sorted(POOL_LAYERS))
def test_pool_layers_match_jax(case):
    factory, shape = POOL_LAYERS[case]
    jl, tl = _build(factory)
    _compare(jl, tl, [_x(*shape, seed=17)])


# --- activations ------------------------------------------------------------
ACTIVATIONS = {
    "relu": lambda F, x: F.relu(x),
    "relu6": lambda F, x: F.relu6(x * 4),
    "sigmoid": lambda F, x: F.sigmoid(x),
    "tanh": lambda F, x: F.tanh(x),
    "softsign": lambda F, x: F.softsign(x),
    "silu": lambda F, x: F.silu(x),
    "mish": lambda F, x: F.mish(x),
    "tanhshrink": lambda F, x: F.tanhshrink(x),
    "log_sigmoid": lambda F, x: F.log_sigmoid(x),
    "gelu": lambda F, x: F.gelu(x),
    "gelu_tanh": lambda F, x: F.gelu(x, approximate=True),
    "leaky_relu": lambda F, x: F.leaky_relu(x, 0.2),
    "elu": lambda F, x: F.elu(x, 0.5),
    "celu": lambda F, x: F.celu(x, 1.5),
    "selu": lambda F, x: F.selu(x),
    "hardshrink": lambda F, x: F.hardshrink(x, 0.3),
    "softshrink": lambda F, x: F.softshrink(x, 0.3),
    "hardtanh": lambda F, x: F.hardtanh(x, -0.5, 0.7),
    "hardsigmoid": lambda F, x: F.hardsigmoid(x * 3),
    "hardswish": lambda F, x: F.hardswish(x * 3),
    "swish": lambda F, x: F.swish(x),
    "softplus": lambda F, x: F.softplus(x * 10, beta=2.0, threshold=5.0),
    "maxout": lambda F, x: F.maxout(x, 2, axis=1),
    "thresholded_relu": lambda F, x: F.thresholded_relu(x, 0.4),
    "softmax": lambda F, x: F.softmax(x, axis=1),
    "log_softmax": lambda F, x: F.log_softmax(x, axis=-1),
    "glu": lambda F, x: F.glu(x, axis=1),
    "rrelu_eval": lambda F, x: F.rrelu(x, training=False),
}


@pytest.mark.parametrize("case", sorted(ACTIVATIONS))
def test_activations_match_jax(case):
    x = _x(3, 4, 5, seed=18)
    x[np.abs(x) < 1e-3] = 0.5      # no input on a kink
    _both(ACTIVATIONS[case], [x])


def test_prelu_matches_jax():
    x, w = _x(2, 3, 4, seed=19), np.asarray([0.1, 0.2, 0.3], np.float32)
    _both(lambda F, xx, ww: F.prelu(xx, ww), [x, w])


def test_random_activations_draw_from_the_port_generator():
    x = pt.to_tensor(-np.abs(_x(4, 64, seed=20)) - 0.1)
    pt.seed(3)
    a = as_np(TF.rrelu(x))
    pt.seed(3)
    b = as_np(TF.rrelu(x))
    np.testing.assert_array_equal(a, b)
    slope = a / as_np(x)
    assert slope.min() >= 0.125 - 1e-6 and slope.max() <= 1 / 3 + 1e-6
    y = as_np(TF.gumbel_softmax(x, hard=True))
    np.testing.assert_array_equal(y.sum(-1), np.ones(4))


ACTIVATION_LAYERS = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Softsign", "Silu",
                     "Mish", "Tanhshrink", "LogSigmoid", "GELU", "ELU",
                     "CELU", "SELU", "LeakyReLU", "Hardshrink", "Softshrink",
                     "Hardtanh", "Hardsigmoid", "Hardswish", "Swish",
                     "Softplus", "ThresholdedReLU", "Maxout", "Softmax",
                     "LogSoftmax", "PReLU", "GLU"]


@pytest.mark.parametrize("name", ACTIVATION_LAYERS)
def test_activation_layers_match_jax(name):
    jl, tl = _build(lambda m: getattr(m, name)())
    x = _x(2, 4, 6, seed=21)
    x[np.abs(x) < 1e-3] = 0.5
    _compare(jl, tl, [x])


# --- AMP op names -------------------------------------------------------------
def test_amp_lists_equal_the_jax_lists_and_cast_the_new_ops_alike():
    """The op lists are the JAX package's; under ``auto_cast`` a conv
    runs in bf16, a batch norm and a pool keep their input's dtype (bf16
    here), in both packages."""
    import importlib

    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as tamp

    # the modules (the packages export the context class under their name)
    jlists = importlib.import_module("paddle_tpu.amp.auto_cast")
    tlists = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

    assert tlists.white_list == jlists.white_list
    assert tlists.black_list == jlists.black_list
    x, w = _x(2, 3, 6, 6, seed=22), _x(4, 3, 3, 3, seed=23)
    dtypes = {}
    for name, pkg, F, amp in (("jax", paddle, JF, jamp),
                              ("torch", pt, TF, tamp)):
        mean, var = pkg.to_tensor(np.zeros(4, np.float32)), \
            pkg.to_tensor(np.ones(4, np.float32))
        with amp.auto_cast(dtype="bfloat16"):
            c = F.conv2d(pkg.to_tensor(x), pkg.to_tensor(w), padding=1)
            bn = F.batch_norm(c, mean, var, training=True, act="relu")
            pooled = F.max_pool2d(bn, 2)
            avg = F.adaptive_avg_pool2d(pooled, 1)
        dtypes[name] = [str(t.dtype).split(".")[-1]
                        for t in (c, bn, pooled, avg)]
    assert dtypes["torch"] == dtypes["jax"] == ["bfloat16"] * 4
