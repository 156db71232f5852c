"""paddle_tpu_torch's normalization against the JAX package on the same
seeded numpy inputs and weights: ``ops/fused_norm.py`` ``bn_train_fused``
(forward, the batch statistics and the backward, with and without the
folded ReLU, with no affine, and the large-mean pivot case of
``tests/test_fused_norm.py``), ``nn.functional.batch_norm`` (the
running statistics over 3 training steps, in place, and the
global-statistics form), the other functional norms, and every layer of
``nn/norm_layers.py`` (its ``state_dict`` names and order, forward,
input and parameter gradients, and the buffers after a training
forward).

Tolerances (f32): forward 1e-5 and gradients 1e-4 absolute and relative
(``tests/torch_layer_parity.py``: the same f32 arithmetic summed in
another order at sizes of at most a few hundred); the statistics 1e-6;
the large-mean case 1e-2 against the two-pass reference (the pivot's
own contract in ``tests/test_fused_norm.py``) and 1e-3 against the JAX
op (at |x| ~ 3000 an f32 ulp is 2.4e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.fused_norm import bn_train_fused as jax_bn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops.fused_norm import bn_train_fused as torch_bn
from torch_layer_parity import FWD, GRAD, as_np
from torch_layer_parity import build as _build
from torch_layer_parity import compare as _compare
from torch_layer_parity import one_torch_thread_on_the_cpu
from torch_layer_parity import rand as _x

EPS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


# --- ops/fused_norm.py ------------------------------------------------------
LAYOUTS = {"nhwc": ((4, 5, 5, 8), (0, 1, 2), 3),
           "nchw": ((4, 8, 5, 5), (0, 2, 3), 1),
           "nc": ((16, 8), (0,), 1)}


def _fused_both(shape, axes, ch, relu, affine=True, pivot=None, seed=0):
    """(JAX (out, mean, var, dx, dw, db), port's) for a seeded case."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    if pivot is not None:
        x = x + pivot
    C = shape[ch]
    w = rng.randn(C).astype(np.float32) if affine else None
    b = rng.randn(C).astype(np.float32) if affine else None
    g = rng.randn(*shape).astype(np.float32)
    piv = None if pivot is None else np.full((C,), pivot, np.float32)

    def jloss(xx, ww, bb):
        out, _, _ = jax_bn(xx, ww, bb, axes, ch, EPS, relu=relu,
                           pivot=None if piv is None else jnp.asarray(piv))
        return jnp.sum(out * g)

    jx = jnp.asarray(x)
    jw = None if w is None else jnp.asarray(w)
    jb = None if b is None else jnp.asarray(b)
    jout, jm, jv = jax_bn(jx, jw, jb, axes, ch, EPS, relu=relu,
                          pivot=None if piv is None else jnp.asarray(piv))
    argn = (0, 1, 2) if affine else (0,)
    jgrads = jax.grad(jloss, argnums=argn)(jx, jw, jb)

    tx = torch.tensor(x, requires_grad=True)
    tw = None if w is None else torch.tensor(w, requires_grad=True)
    tb = None if b is None else torch.tensor(b, requires_grad=True)
    tout, tm, tv = torch_bn(tx, tw, tb, axes, ch, EPS, relu=relu,
                            pivot=None if piv is None else torch.tensor(piv))
    (tout * torch.from_numpy(g)).sum().backward()
    tgrads = [tx.grad] + ([tw.grad, tb.grad] if affine else [])
    return ([np.asarray(a) for a in (jout, jm, jv)]
            + [np.asarray(a) for a in jgrads],
            [t.detach().numpy() for t in (tout, tm, tv)]
            + [t.numpy() for t in tgrads])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
def test_bn_train_fused_matches_jax(layout, relu):
    shape, axes, ch = LAYOUTS[layout]
    want, got = _fused_both(shape, axes, ch, relu)
    names = ("out", "mean", "var", "dx", "dw", "db")
    for name, w, g in zip(names, want, got):
        tol = FWD if name in ("out", "mean", "var") else GRAD
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def test_bn_train_fused_without_affine_matches_jax():
    shape, axes, ch = LAYOUTS["nhwc"]
    want, got = _fused_both(shape, axes, ch, True, affine=False, seed=2)
    for name, w, g in zip(("out", "mean", "var", "dx"), want, got):
        np.testing.assert_allclose(g, w, err_msg=name, **(
            FWD if name != "dx" else GRAD))


def test_bn_train_fused_pivot_steadies_a_large_mean():
    """x ~ N(3000, 1) with the pivot at 3000: the output within 1e-2 of
    the two-pass reference (as the JAX op's own test) and within 1e-3 of
    the JAX op; the variance within 1e-3 of the two-pass one."""
    shape, axes, ch = LAYOUTS["nhwc"]
    want, got = _fused_both(shape, axes, ch, False, pivot=3000.0, seed=1)
    rng = np.random.RandomState(1)
    x = (rng.randn(*shape) + 3000.0).astype(np.float64)
    w = rng.randn(shape[ch])
    b = rng.randn(shape[ch])
    ref = (x - x.mean(axes)) / np.sqrt(x.var(axes) + EPS) * w + b
    np.testing.assert_allclose(got[0], ref, atol=1e-2)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    np.testing.assert_allclose(got[2], x.var(axes), atol=1e-3)


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
def test_bn_train_fused_in_bf16_is_the_f32_op_rounded(relu):
    """A bf16 input: f32 statistics, and the output and dx in bf16 equal
    to the f32 op's on the same (exactly widened) values, rounded once —
    the JAX op's final cast."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 4, 8, generator=gen).to(torch.bfloat16)
    g = torch.randn(2, 4, 4, 8, generator=gen).to(torch.bfloat16)
    w, b = torch.randn(8, generator=gen), torch.randn(8, generator=gen)
    res = []
    for xx, gg in ((x, g), (x.float(), g.float())):
        xx = xx.clone().requires_grad_(True)
        out, m, var = torch_bn(xx, w, b, (0, 1, 2), 3, EPS, relu=relu)
        out.backward(gg)
        res.append((out.detach(), m, var, xx.grad))
    (o16, m16, v16, dx16), (o32, m32, v32, dx32) = res
    assert o16.dtype == dx16.dtype == torch.bfloat16
    assert m16.dtype == v16.dtype == torch.float32
    assert torch.equal(m16, m32) and torch.equal(v16, v32)
    assert torch.equal(o16, o32.to(torch.bfloat16))
    assert torch.equal(dx16, dx32.to(torch.bfloat16))


# --- nn/functional/norm.py ---------------------------------------------------
@pytest.mark.parametrize("data_format,shape", [("NCHW", (4, 6, 5, 5)),
                                               ("NHWC", (4, 5, 5, 6)),
                                               ("NC", (8, 6)),
                                               ("NCL", (4, 6, 7))])
def test_batch_norm_running_stats_over_three_steps(data_format, shape):
    """Three training calls on fresh batches: every output and both
    running statistics after each call within 1e-5 / 1e-6 of the JAX
    package's, the port's statistics updated in the same tensors."""
    C = shape[1] if data_format.startswith("NC") else shape[-1]
    rng = np.random.RandomState(3)
    w = rng.randn(C).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    jm, jv = paddle.zeros([C]), paddle.ones([C])
    tm, tv = pt.to_tensor(np.zeros(C, np.float32)), \
        pt.to_tensor(np.ones(C, np.float32))
    tm_ptr, tv_ptr = tm._value.data_ptr(), tv._value.data_ptr()
    for step in range(3):
        x = (rng.randn(*shape) * (step + 1) + step).astype(np.float32)
        jo = JF.batch_norm(paddle.to_tensor(x), jm, jv, paddle.to_tensor(w),
                           paddle.to_tensor(b), training=True,
                           data_format=data_format, act="relu")
        to = TF.batch_norm(pt.to_tensor(x), tm, tv, pt.to_tensor(w),
                           pt.to_tensor(b), training=True,
                           data_format=data_format, act="relu")
        np.testing.assert_allclose(as_np(to), as_np(jo), **FWD)
        np.testing.assert_allclose(as_np(tm), as_np(jm), atol=1e-6)
        np.testing.assert_allclose(as_np(tv), as_np(jv), atol=1e-6)
    assert (tm._value.data_ptr(), tv._value.data_ptr()) == (tm_ptr, tv_ptr)
    # the global-statistics form reads them and updates nothing
    x = rng.randn(*shape).astype(np.float32)
    jo = JF.batch_norm(paddle.to_tensor(x), jm, jv, paddle.to_tensor(w),
                       paddle.to_tensor(b), training=False,
                       data_format=data_format)
    before = as_np(tm).copy()
    to = TF.batch_norm(pt.to_tensor(x), tm, tv, pt.to_tensor(w),
                       pt.to_tensor(b), training=False,
                       data_format=data_format)
    np.testing.assert_allclose(as_np(to), as_np(jo), **FWD)
    np.testing.assert_array_equal(as_np(tm), before)


def test_batch_norm_momentum_is_the_share_kept():
    """paddle's momentum 0.9 keeps 0.9 of the old statistic (torch's 0.1
    would take 0.1 of the batch's: the same here) and the running
    variance takes the biased batch variance (torch: unbiased)."""
    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    rm, rv = pt.to_tensor(np.zeros(1, np.float32)), \
        pt.to_tensor(np.ones(1, np.float32))
    TF.batch_norm(pt.to_tensor(x), rm, rv, training=True, momentum=0.9,
                  data_format="NC")
    np.testing.assert_allclose(as_np(rm), [0.1 * x.mean()], rtol=1e-6)
    np.testing.assert_allclose(as_np(rv), [0.9 + 0.1 * x.var()], rtol=1e-6)


FUNCTIONAL = {
    "instance_norm": (lambda F, x, w, b: F.instance_norm(
        x, weight=w, bias=b), (2, 3, 5, 4)),
    "instance_norm_nhwc": (lambda F, x, w, b: F.instance_norm(
        x, weight=w, bias=b, data_format="NHWC"), (2, 5, 4, 3)),
    "group_norm": (lambda F, x, w, b: F.group_norm(x, 3, 1e-5, w, b),
                   (2, 6, 4, 4)),
    "group_norm_nhwc": (lambda F, x, w, b: F.group_norm(
        x, 3, 1e-5, w, b, data_format="NHWC"), (2, 4, 4, 6)),
    "layer_norm": (lambda F, x, w, b: F.layer_norm(x, [4, 6], None, None),
                   (2, 3, 4, 6)),
    "lrn": (lambda F, x, w, b: F.local_response_norm(x, 5, 1e-2, 0.75, 2.0),
            (2, 7, 3, 3)),
    "lrn_nhwc": (lambda F, x, w, b: F.local_response_norm(
        x, 4, 1e-2, 0.75, 1.0, data_format="NHWC"), (2, 3, 3, 7)),
    "normalize": (lambda F, x, w, b: F.normalize(x, p=2, axis=1),
                  (3, 5, 2)),
    "normalize_p1": (lambda F, x, w, b: F.normalize(x, p=1, axis=-1),
                     (3, 5)),
}


@pytest.mark.parametrize("case", sorted(FUNCTIONAL))
def test_functional_norms_match_jax(case):
    fn, shape = FUNCTIONAL[case]
    x = _x(*shape, seed=4)
    C = shape[-1] if "nhwc" in case else shape[1]
    w, b = _x(C, seed=5), _x(C, seed=6)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = pt.to_tensor(x, stop_gradient=False)
    jo = fn(JF, jx, paddle.to_tensor(w), paddle.to_tensor(b))
    to = fn(TF, tx, pt.to_tensor(w), pt.to_tensor(b))
    np.testing.assert_allclose(as_np(to), as_np(jo), **FWD)
    g = _x(*shape, seed=7)
    (jo * paddle.to_tensor(g)).sum().backward()
    (to * pt.to_tensor(g)).sum().backward()
    np.testing.assert_allclose(as_np(tx.grad), as_np(jx.grad), **GRAD)


def test_instance_norm_refuses_running_statistics():
    x = pt.to_tensor(_x(2, 3, 4, 4))
    with pytest.raises(InvalidArgumentError):
        TF.instance_norm(x, use_input_stats=False)


# --- nn/norm_layers.py -------------------------------------------------------
LAYERS = {
    "BatchNorm1D_nc": (lambda m: m.BatchNorm1D(6, data_format="NC"), (8, 6)),
    "BatchNorm1D_ncl": (lambda m: m.BatchNorm1D(6, data_format="NCL"),
                        (4, 6, 5)),
    "BatchNorm2D": (lambda m: m.BatchNorm2D(6), (4, 6, 5, 5)),
    "BatchNorm2D_nhwc_relu": (lambda m: m.BatchNorm2D(
        6, data_format="NHWC", act="relu"), (4, 5, 5, 6)),
    "BatchNorm2D_momentum": (lambda m: m.BatchNorm2D(
        6, momentum=0.5, epsilon=1e-3), (4, 6, 3, 3)),
    "BatchNorm2D_no_affine": (lambda m: m.BatchNorm2D(
        6, weight_attr=False, bias_attr=False), (4, 6, 3, 3)),
    "BatchNorm3D": (lambda m: m.BatchNorm3D(4, data_format="NCDHW"),
                    (2, 4, 3, 3, 3)),
    "BatchNorm_legacy_relu": (lambda m: m.BatchNorm(6, act="relu"),
                              (4, 6, 3, 3)),
    "BatchNorm_legacy_sigmoid": (lambda m: m.BatchNorm(6, act="sigmoid"),
                                 (4, 6, 3, 3)),
    "SyncBatchNorm": (lambda m: m.SyncBatchNorm(6), (4, 6, 3, 3)),
    "GroupNorm": (lambda m: m.GroupNorm(2, 6), (2, 6, 4, 4)),
    "InstanceNorm1D": (lambda m: m.InstanceNorm1D(4, data_format="NCL"),
                       (2, 4, 7)),
    "InstanceNorm2D": (lambda m: m.InstanceNorm2D(4), (2, 4, 5, 5)),
    "InstanceNorm3D": (lambda m: m.InstanceNorm3D(4, data_format="NCDHW"),
                       (2, 4, 3, 3, 3)),
    "LocalResponseNorm": (lambda m: m.LocalResponseNorm(3), (2, 6, 4, 4)),
    "LayerNorm": (lambda m: m.LayerNorm([5, 6]), (2, 3, 5, 6)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_norm_layers_match_jax(case):
    """Training mode: forward, gradients and (batch norms) the running
    statistics after the call; then eval mode on the updated
    statistics."""
    factory, shape = LAYERS[case]
    jl, tl = _build(factory)
    x = _x(*shape, seed=8) * 2.0 + 0.5
    _compare(jl, tl, [x])
    for name, buf in jl.named_buffers():
        np.testing.assert_allclose(as_np(tl.state_dict()[name]), as_np(buf),
                                   atol=1e-6, err_msg=name)
    jl.eval()
    tl.eval()
    _compare(jl, tl, [_x(*shape, seed=9)], grad=False)


def test_norm_layer_state_dict_names_and_buffers():
    bn = tnn.BatchNorm2D(4)
    assert list(bn.state_dict()) == ["weight", "bias", "_mean", "_variance"]
    assert [n for n, _ in bn.named_buffers()] == ["_mean", "_variance"]
    assert len(bn.parameters()) == 2
    bn.register_buffer("scratch", torch.zeros(2), persistable=False)
    assert "scratch" not in bn.state_dict()
    assert [n for n, _ in bn.named_buffers()][-1] == "scratch"


def test_set_state_dict_copies_buffers_in_place():
    bn = tnn.BatchNorm2D(4)
    ptr = bn._mean._value.data_ptr()
    state = {"_mean": np.full(4, 2.0, np.float32),
             "_variance": np.full(4, 3.0, np.float32)}
    missing, unexpected = bn.set_state_dict(state)
    assert missing == ["weight", "bias"] and unexpected == []
    assert bn._mean._value.data_ptr() == ptr
    np.testing.assert_array_equal(as_np(bn._mean), state["_mean"])


def test_layer_to_moves_parameters_and_buffers():
    bn = tnn.BatchNorm2D(4)
    bn.to(dtype="bfloat16")
    assert bn.weight.dtype == torch.bfloat16
    assert bn._mean.dtype == torch.bfloat16
    assert not bn.weight.stop_gradient and bn.weight.is_leaf
    bn.to(device="cpu", dtype="float32")
    assert bn._variance.dtype == torch.float32


def test_convert_sync_batchnorm_keeps_the_tensors():
    seq = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4, act="relu"))
    mean = seq[1]._mean
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(seq)
    assert isinstance(out[1], tnn.SyncBatchNorm)
    assert out[1]._fused_act == "relu" and out[1]._mean is mean


def test_spectral_norm_matches_jax():
    """Forward and the weight's gradient (``weight_v`` is overwritten by
    the first power step: the port leaves it no gradient, the JAX tape a
    zero one)."""
    jl, tl = _build(lambda m: m.SpectralNorm([6, 4], dim=0, power_iters=2))
    w = _x(6, 4, seed=10)
    jw = paddle.to_tensor(w, stop_gradient=False)
    tw = pt.to_tensor(w, stop_gradient=False)
    jo, to = jl(jw), tl(tw)
    np.testing.assert_allclose(as_np(to), as_np(jo), **FWD)
    jo.sum().backward()
    to.sum().backward()
    np.testing.assert_allclose(as_np(tw.grad), as_np(jw.grad), **GRAD)
    np.testing.assert_allclose(as_np(tl.weight_u.grad),
                               as_np(jl.weight_u.grad), **GRAD)
    assert not as_np(jl.weight_v.grad).any() and tl.weight_v.grad is None
