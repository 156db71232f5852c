"""paddle_tpu_torch's dygraph core and custom-op API vs the JAX package.

The same numpy inputs (and, for the nets, the same weights, copied from
paddle_tpu with ``state_from_numpy``) go through paddle_tpu and the
port, on the CPU:

- twins of the five ``TestRegisterOp`` tests of
  ``tests/test_custom_op.py:25-91``, each user function written in torch;
  grads against paddle_tpu's at rtol 1e-5 (the same few f32 ops);
- the worked Pallas example (row t, ``_pallas_scale_shift``, copied
  below so this file stands alone) against the port's
  ``ops.scale_shift``: the op's output against the JAX kernel in
  interpret mode, f32 at rtol 1e-6 and atol 1e-6 (the port rounds the
  product and then the sum; XLA on the CPU fuses them into one FMA, so
  an element near cancellation differs by an ulp of the product);
- ``test_trains_eager``'s net (Linear, the scale-shift layer, Linear)
  from paddle_tpu's initial weights: the 15 Adam losses at rtol 1e-5 (the
  same f32 ops and update rule, summed in other orders);
- ``Tensor`` semantics: list shapes, grads None before backward and
  after ``clear_grad``, accumulation over two backwards, ``no_grad``, the
  ``check_nan_inf`` sweep, the AMP lists, the operator error prefix and a
  CUDA place without a card.

``test_trains_static``'s twin is ``tests/test_torch_static.py``'s
``test_custom_op_trains_static``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.utils import register_op as jregister
from paddle_tpu.utils import unregister_op as junregister

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp, autograd, nn, optimizer
from paddle_tpu_torch.framework import flags, place
from paddle_tpu_torch.nn.layer import state_from_numpy
from paddle_tpu_torch.ops.scale_shift import (SCALE_SHIFT_ROUTE_STATS,
                                              scale_shift, scale_shift_vjp)
from paddle_tpu_torch.utils import (get_op, register_op, registered_ops,
                                    unregister_op)

NAMES = ("t_swish", "t_vjp", "t_fwdbwd", "t_pallas", "t_amp", "t_black",
         "t_dup", "t_nan", "t_err")


@pytest.fixture(autouse=True)
def _cpu_and_clean_registry():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev
    for name in NAMES:
        unregister_op(name)
        junregister(name)


def _pair(arr, stop_gradient=False):
    """The same array as a paddle_tpu and a port Tensor."""
    j = paddle.to_tensor(arr)
    t = pt.to_tensor(arr)
    j.stop_gradient = stop_gradient
    t.stop_gradient = stop_gradient
    return j, t


def _close(port_t, jax_t, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(port_t.numpy(), np.asarray(jax_t._value),
                               rtol=rtol, atol=atol)


# =============================================================================
# twins of TestRegisterOp
# =============================================================================
class TestRegisterOp:
    def test_basic_autodiff(self):
        jop = jregister("t_swish",
                        lambda x, beta=1.0: x * jax.nn.sigmoid(beta * x))
        op = register_op("t_swish",
                         lambda x, beta=1.0: x * torch.sigmoid(beta * x))
        jx, x = _pair(np.random.RandomState(0).randn(4, 4).astype(
            np.float32))
        jop(jx, beta=2.0).sum().backward()
        y = op(x, beta=2.0)
        y.sum().backward()
        _close(y, jop(jx, beta=2.0))
        _close(x.grad, jx.grad)

    def test_recompute_style_vjp(self):
        jregister("t_vjp", lambda x, w: x @ w,
                  vjp=lambda ct, x, w: (ct @ w.T, x.T @ ct))
        op = register_op("t_vjp", lambda x, w: x @ w,
                         vjp=lambda ct, x, w: (ct @ w.T, x.T @ ct))
        rng = np.random.RandomState(0)
        jx, x = _pair(rng.randn(3, 5).astype(np.float32))
        jw, w = _pair(rng.randn(5, 2).astype(np.float32))
        paddle.utils.get_op("t_vjp")(jx, jw).sum().backward()
        op(x, w).sum().backward()
        _close(x.grad, jx.grad)
        _close(w.grad, jw.grad)

    def test_fwd_bwd_pair_with_residuals(self):
        def jfwd(x):
            y = jnp.tanh(x)
            return y, y

        def tfwd(x):
            y = torch.tanh(x)
            return y, y

        jregister("t_fwdbwd", jnp.tanh, fwd=jfwd,
                  bwd=lambda res, ct: (ct * (1 - res * res),))
        op = register_op("t_fwdbwd", torch.tanh, fwd=tfwd,
                         bwd=lambda res, ct: (ct * (1 - res * res),))
        jx, x = _pair(np.random.RandomState(1).randn(6).astype(np.float32))
        paddle.utils.get_op("t_fwdbwd")(jx).sum().backward()
        op(x).sum().backward()
        _close(x.grad, jx.grad)
        np.testing.assert_allclose(
            x.grad.numpy(), 1 - np.tanh(x.numpy()) ** 2, rtol=1e-5)

    def test_fwd_bwd_residuals_may_mix_tensors_and_values(self):
        """Residuals of any structure come back to ``bwd`` as they were
        (tensors through ``save_for_backward``); a non-tensor input of a
        ``vjp=`` op reaches the vjp too."""
        op = register_op("t_fwdbwd", lambda x, k: x * k,
                         fwd=lambda x, k: (x * k, (x, k)),
                         bwd=lambda res, ct: (ct * res[1], None))
        x = pt.to_tensor(np.arange(3, dtype=np.float32),
                         stop_gradient=False)
        op(x, 3.0).sum().backward()
        np.testing.assert_array_equal(x.grad.numpy(), np.full(3, 3.0))
        op2 = register_op("t_vjp", lambda x, k: x * k,
                          vjp=lambda ct, x, k: (ct * k, None))
        y = pt.to_tensor(np.ones(2, np.float32), stop_gradient=False)
        op2(y, 5.0).sum().backward()
        np.testing.assert_array_equal(y.grad.numpy(), np.full(2, 5.0))

    def test_duplicate_name_raises(self):
        register_op("t_dup", lambda x: x)
        with pytest.raises(ValueError, match="already registered"):
            register_op("t_dup", lambda x: x + 1)
        op = register_op("t_dup", lambda x: x + 1, exist_ok=True)
        assert get_op("t_dup") is op and "t_dup" in registered_ops()
        with pytest.raises(ValueError, match="not both"):
            register_op("t_vjp", lambda x: x, vjp=lambda c, x: c,
                        fwd=lambda x: (x, x), bwd=lambda r, c: c)
        with pytest.raises(ValueError, match="together"):
            register_op("t_vjp", lambda x: x, fwd=lambda x: (x, x))
        with pytest.raises(ValueError, match="amp"):
            register_op("t_vjp", lambda x: x, amp="grey")
        assert "t_vjp" not in registered_ops()

    def test_amp_white_listed(self):
        jop = jregister("t_amp", lambda x: x * 2.0, amp="white")
        op = register_op("t_amp", lambda x: x * 2.0, amp="white")
        jx, x = _pair(np.ones((4, 4), np.float32), stop_gradient=True)
        with paddle.amp.auto_cast(dtype="bfloat16"):
            jy = jop(jx)
        with amp.auto_cast(dtype="bfloat16"):
            y = op(x)
        assert str(y.dtype).endswith("bfloat16")
        assert str(jy.dtype).endswith("bfloat16")
        # registered for the life of the process, as in paddle_tpu
        unregister_op("t_amp")
        assert "t_amp" in amp.white_list


# =============================================================================
# row t: the worked Pallas example (copied from tests/test_custom_op.py)
# =============================================================================
def _pallas_scale_shift(x, scale, shift):
    """Worked Pallas example: fused y = x*scale + shift elementwise kernel
    (interpret mode off-TPU)."""
    from jax.experimental import pallas as pl

    def kernel(x_ref, s_ref, b_ref, o_ref):
        o_ref[:] = x_ref[:] * s_ref[0] + b_ref[0]

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=jax.default_backend() != "tpu",
    )(x, scale.reshape(1), shift.reshape(1))


def _pallas_scale_shift_vjp(ct, x, scale, shift):
    return (_pallas_scale_shift(ct, scale, jnp.zeros_like(shift)),
            jnp.sum(ct * x).reshape(()),
            jnp.sum(ct).reshape(()))


class _JaxPallasScaleLayer(jnn.Layer):
    def __init__(self, op):
        super().__init__()
        self._op = op
        self.scale = self.create_parameter([1])
        self.shift = self.create_parameter([1], is_bias=True)

    def forward(self, x):
        return self._op(x, self.scale.reshape([]), self.shift.reshape([]))


class _ScaleShiftLayer(nn.Layer):
    """The port's twin of ``_PallasScaleLayer``: 1-element parameters,
    reshaped to 0-d for the op; grads flow back through the reshape."""

    def __init__(self, op):
        super().__init__()
        self._op = op
        self.scale = self.create_parameter([1])
        self.shift = self.create_parameter([1], is_bias=True)

    def forward(self, x):
        return self._op(x, self.scale.reshape([]), self.shift.reshape([]))


@pytest.mark.parametrize("shape", [(4, 8), (16, 8), (1000,)])
def test_pallas_matches_reference_math(shape):
    """The op's output against the JAX Pallas kernel in interpret mode,
    and the paddle_tpu test's own check (x * 3 - 1)."""
    jop = jregister("t_pallas", _pallas_scale_shift,
                    vjp=_pallas_scale_shift_vjp, exist_ok=True)
    op = register_op("t_pallas", scale_shift, vjp=scale_shift_vjp,
                     exist_ok=True)
    xa = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jgot = jop(paddle.to_tensor(xa), paddle.to_tensor(np.float32(3.0)),
               paddle.to_tensor(np.float32(-1.0)))
    before = dict(SCALE_SHIFT_ROUTE_STATS)
    got = op(pt.to_tensor(xa), pt.to_tensor(np.float32(3.0)),
             pt.to_tensor(np.float32(-1.0)))
    assert SCALE_SHIFT_ROUTE_STATS["ref"] == before["ref"] + 1
    assert got.shape == list(shape) and got.dtype == torch.float32
    _close(got, jgot, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), xa * 3.0 - 1.0, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_scale_shift_low_precision_computes_in_f32(dtype):
    """bf16/f16 x: the product and the sum in f32, one rounding to x's
    dtype at the end.  (The Pallas example takes only x's own dtype for
    scale and shift, so there is no JAX twin of this case.)"""
    xa = np.random.RandomState(2).randn(4, 8).astype(np.float32)
    x = torch.from_numpy(xa).to(dtype)
    got = scale_shift(x, torch.tensor([1.7]), torch.tensor([0.3]))
    want = (x.float().numpy() * np.float32(1.7)) + np.float32(0.3)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, torch.from_numpy(want).to(dtype))


def test_scale_shift_vjp_matches_the_pallas_vjp():
    rng = np.random.RandomState(4)
    ct, x = (rng.randn(16, 8).astype(np.float32) for _ in range(2))
    s, b = np.float32(0.7), np.float32(-0.2)
    want = _pallas_scale_shift_vjp(jnp.asarray(ct), jnp.asarray(x),
                                   jnp.asarray(s), jnp.asarray(b))
    got = scale_shift_vjp(torch.from_numpy(ct), torch.from_numpy(x),
                          torch.tensor(s), torch.tensor(b))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def test_scale_shift_rejects_bad_inputs():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="float32, bfloat16"):
        scale_shift(torch.ones(4, 8, dtype=torch.int32), torch.ones(1),
                    torch.zeros(1))
    with pytest.raises(ValueError, match="one element"):
        scale_shift(x, torch.ones(2), torch.zeros(1))
    with pytest.raises(ValueError, match="one element"):
        scale_shift(x, torch.ones(1), torch.zeros(1, 2))


def _train(net, opt, xa, ya, steps, wrap):
    x, y = wrap(xa), wrap(ya)
    losses = []
    for _ in range(steps):
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def test_trains_eager():
    """paddle_tpu's ``test_trains_eager`` net and data through both
    packages from the same initial weights: 15 Adam(5e-2) steps, the
    losses at rtol 1e-5; the loss halves, as the JAX test asserts, and
    every step ran the scale-shift op's forward and dx once."""
    jop = jregister("t_pallas", _pallas_scale_shift,
                    vjp=_pallas_scale_shift_vjp, exist_ok=True)
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(8, 8), _JaxPallasScaleLayer(jop),
                          jnn.Linear(8, 1))
    state = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    rng = np.random.RandomState(0)
    xa = rng.randn(16, 8).astype(np.float32)
    ya = (rng.randn(16, 1) * 0.1 + 1.0).astype(np.float32)
    want = _train(jnet, jopt.Adam(5e-2, parameters=jnet.parameters()),
                  xa, ya, 15, paddle.to_tensor)

    op = register_op("t_pallas", scale_shift, vjp=scale_shift_vjp,
                     exist_ok=True)
    pt.seed(0)
    net = nn.Sequential(nn.Linear(8, 8), _ScaleShiftLayer(op),
                        nn.Linear(8, 1))
    assert [k for k, _ in net.named_parameters()] == list(state)
    missing, unexpected = net.set_state_dict(state_from_numpy(state, "cpu"))
    assert missing == [] and unexpected == []
    before = SCALE_SHIFT_ROUTE_STATS["ref"]
    got = _train(net, optimizer.Adam(5e-2, parameters=net.parameters()),
                 xa, ya, 15, pt.to_tensor)
    assert SCALE_SHIFT_ROUTE_STATS["ref"] == before + 30
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0] * 0.5


# =============================================================================
# Tensor and dispatch semantics
# =============================================================================
def test_shape_is_a_list_and_dtype_names_match():
    j, t = _pair(np.zeros((2, 3), np.float32), stop_gradient=True)
    assert t.shape == j.shape == [2, 3]
    assert str(t.dtype).endswith("float32") and str(j.dtype) == "float32"
    assert t.ndim == 2 and t.size == 6 and len(t) == 2
    assert pt.to_tensor(np.float64(1.5)).dtype == torch.float32
    assert pt.to_tensor([1, 2]).dtype == torch.int64
    assert float(pt.to_tensor(np.float32(2.5))) == 2.5


def test_stop_gradient_leaf_semantics():
    x = pt.to_tensor(np.ones(3, np.float32))
    assert x.stop_gradient and x.is_leaf
    x.stop_gradient = False
    assert not x.stop_gradient and x.is_leaf
    y = x * 2.0
    assert not y.stop_gradient and not y.is_leaf
    p = nn.Linear(2, 2).weight
    assert isinstance(p, pt.Parameter) and not p.stop_gradient and p.is_leaf
    y.stop_gradient = True                  # cuts the graph there
    assert y.stop_gradient


def test_grads_none_accumulate_and_clear():
    jx, x = _pair(np.arange(4, dtype=np.float32))
    assert x.grad is None and jx.grad is None
    for t in (x, jx):
        (t * t).sum().backward()
        (t * 3.0).sum().backward()
    _close(x.grad, jx.grad)
    np.testing.assert_allclose(x.grad.numpy(), 2 * np.arange(4) + 3.0)
    x.clear_grad()
    assert x.grad is None


def test_non_leaf_grad_needs_retain_grads():
    x = pt.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    h, k = x * 2.0, x * 3.0
    k.retain_grads()
    (h * k).sum().backward()
    assert h.grad is None
    np.testing.assert_allclose(k.grad.numpy(), 2.0 * np.ones(3))


def test_no_grad_and_grad_mode_switches():
    x = pt.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    with autograd.no_grad():
        assert not autograd.is_grad_enabled()
        y = x * 2.0
        with autograd.enable_grad():
            z = x * 2.0
    assert y.stop_gradient and not z.stop_gradient
    with autograd.set_grad_enabled(False):
        assert (x + 1.0).stop_gradient
    assert autograd.is_grad_enabled()


def test_optimizer_clear_grad_on_layer_parameters():
    lin = nn.Linear(3, 2)
    before = lin.weight.numpy().copy()
    opt = optimizer.SGD(0.1, parameters=lin.parameters())
    lin(pt.to_tensor(np.ones((4, 3), np.float32))).sum().backward()
    assert lin.weight.grad is not None
    opt.step()
    assert not np.array_equal(lin.weight.numpy(), before)  # in place
    opt.clear_grad()
    assert lin.weight.grad is None and lin.bias.grad is None


def test_check_nan_inf_sweep_names_the_op():
    jop = jregister("t_nan", lambda x: jnp.log(x))
    op = register_op("t_nan", torch.log)
    arr = np.array([1.0, -1.0], np.float32)
    op(pt.to_tensor(arr))                  # flag off: no sweep
    flags.set_flags({"FLAGS_check_nan_inf": True})
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        assert flags.get_flags("FLAGS_check_nan_inf") == {
            "FLAGS_check_nan_inf": True}
        with pytest.raises(FloatingPointError, match="t_nan output #0"):
            op(pt.to_tensor(arr))
        with pytest.raises(FloatingPointError, match="t_nan output #0"):
            jop(paddle.to_tensor(arr))
    finally:
        flags.set_flags({"FLAGS_check_nan_inf": False})
        paddle.set_flags({"FLAGS_check_nan_inf": False})


def test_errors_carry_the_operator_prefix():
    def boom(x):
        raise ValueError("bad input")

    op = register_op("t_err", boom)
    with pytest.raises(RuntimeError, match=r"\[operator < t_err >\] bad"):
        op(pt.to_tensor(np.ones(2, np.float32), stop_gradient=False))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_white_and_black_lists_cast_as_paddle_tpu(level):
    """linear (white) runs in bf16, reduce_mean (black) in f32, an op on
    neither list keeps its input dtype at O1 — the same in both
    packages; an ``amp="black"`` custom op is pinned to f32."""
    import paddle_tpu.nn.functional as JF
    from paddle_tpu_torch.nn import functional as F

    rng = np.random.RandomState(5)
    jx, x = _pair(rng.randn(4, 3).astype(np.float32), stop_gradient=True)
    jw, w = _pair(rng.randn(3, 2).astype(np.float32), stop_gradient=True)
    jregister("t_black", lambda v: v + 1.0, amp="black")
    op = register_op("t_black", lambda v: v + 1.0, amp="black")
    with paddle.amp.auto_cast(dtype="bfloat16", level=level):
        jlin = JF.linear(jx, jw)
        jmean = jlin.mean()
        jneg = -jlin
        jblack = paddle.utils.get_op("t_black")(jlin)
    with amp.auto_cast(dtype="bfloat16", level=level):
        lin = F.linear(x, w)
        mean = lin.mean()
        neg = -lin
        black = op(lin)
    for got, want in ((lin, jlin), (mean, jmean), (neg, jneg),
                      (black, jblack)):
        assert str(got.dtype).rsplit(".", 1)[-1] == str(want.dtype), (
            got.dtype, want.dtype)
    assert lin.dtype == torch.bfloat16 and mean.dtype == torch.float32
    assert black.dtype == torch.float32
    _close(lin.astype("float32"), jlin.astype("float32"), rtol=1e-2)


def test_cuda_place_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for dev in ("gpu", "gpu:0", "cuda"):
        with pytest.raises(RuntimeError, match="is_available"):
            pt.set_device(dev)
        with pytest.raises(RuntimeError, match="is_available"):
            pt.to_tensor(np.ones(2, np.float32), place=dev)
    assert pt.get_device() == "cpu"
    place._DEFAULT["device"] = None         # the default place is the card
    with pytest.raises(RuntimeError, match="is_available"):
        pt.to_tensor(np.ones(2, np.float32))
    with pytest.raises(RuntimeError, match="is_available"):
        nn.Linear(2, 2)
    with pytest.raises(ValueError, match="unknown device"):
        pt.set_device("tpu")


def test_seed_replays_initial_weights():
    pt.seed(7)
    a = nn.Linear(4, 3).weight.numpy()
    pt.seed(7)
    b = nn.Linear(4, 3).weight.numpy()
    np.testing.assert_array_equal(a, b)
    std = np.sqrt(2.0 / (4 + 3))           # XavierNormal, as paddle_tpu
    assert 0.2 * std < a.std() < 3 * std
    state = torch.random.get_rng_state()
    pt.seed(8)
    nn.Linear(4, 3)
    assert torch.equal(state, torch.random.get_rng_state())


def test_layer_registration_and_state_dict_round_trip():
    net = nn.Sequential(nn.Linear(3, 4), nn.ReLU(), nn.Linear(4, 2))
    names = [k for k, _ in net.named_parameters()]
    assert names == ["0.weight", "0.bias", "2.weight", "2.bias"]
    assert len(net.parameters()) == 4 and len(net) == 3
    state = {k: np.full(tuple(v.shape), i, np.float32)
             for i, (k, v) in enumerate(net.state_dict().items())}
    held = net[0].weight._value
    assert net.set_state_dict(state_from_numpy(state, "cpu")) == ([], [])
    assert net[0].weight._value is held     # copied in place
    np.testing.assert_array_equal(net[2].bias.numpy(), np.full(2, 3.0))
    missing, unexpected = net.set_state_dict({"0.bias": np.zeros(4),
                                              "extra": np.zeros(1)})
    assert missing == ["0.weight", "2.weight", "2.bias"]
    assert unexpected == ["extra"]
    with pytest.raises(ValueError, match="shape mismatch"):
        net.set_state_dict({"0.bias": np.zeros(5)})
    net.eval()
    assert not any(layer.training for layer in net.sublayers(True))
