"""The eager surface of ``import paddle_tpu_torch as paddle`` against
``import paddle_tpu as paddle`` on the CPU: the ``Tensor`` methods the
port adds (``numel`` ... ``__index__``), the in-place aliases and
``__setitem__`` (an out-of-place result adopted, gradients through it),
the method forms of the ops, ``autograd.grad`` / ``backward``, dtypes,
places, the fluid-era names of ``compat`` and ``save`` / ``load``.

Values are compared exactly where nothing is computed and within 1e-6
where f32 arithmetic is; dtypes as ``torch_op_parity.DESIGN_DTYPES``
allows (int64 in the port where JAX gives int32)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from torch_op_parity import EXACT, compare, rng, to_numpy

F32 = (1e-6, 1e-6)
X = rng(31).uniform(-2, 2, (3, 4)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def _pair(a=X, stop_gradient=True):
    return (jp.to_tensor(a, stop_gradient=stop_gradient),
            pt.to_tensor(a, stop_gradient=stop_gradient))


def test_metadata_and_host_methods_match_reference():
    j, t = _pair()
    assert t.numel() == j.numel() == 12
    assert t.dim() == j.dim() == 2 and t.rank() == j.rank() == 2
    assert t.tolist() == j.tolist()
    compare(np.asarray(t), np.asarray(j), EXACT, "__array__")
    assert np.asarray(t, dtype=np.float64).dtype == np.float64
    s = pt.to_tensor(np.array(3.7, np.float32))
    assert int(s) == int(jp.to_tensor(np.array(3.7, np.float32))) == 3
    assert bool(pt.to_tensor(np.array(1.0))) is True
    assert [10, 20, 30][pt.to_tensor(np.array(2))] == 30
    with pytest.raises(ValueError):
        bool(t)
    assert t.is_contiguous() and t.contiguous() is t
    assert t.transpose([1, 0]).contiguous().is_contiguous()
    assert t.pin_memory() is t or t.pin_memory().numpy().tolist() == \
        t.tolist()
    assert t.cpu().place.type == "cpu"
    assert t.to("float64").dtype == torch.float64
    assert t.to(pt.CPUPlace()).place.type == "cpu"
    assert t.to("cpu").dtype == torch.float32
    assert t.inplace_version == t.value._version


def test_clone_detach_and_set_value():
    j, t = _pair(stop_gradient=False)
    c = t.clone()
    assert not c.stop_gradient and not c.is_leaf
    (c * 2).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.full_like(X, 2.0))
    t.clear_gradient()
    assert t.grad is None
    y = t * 3
    y.detach_()
    assert y.stop_gradient and y.is_leaf
    storage = t.value
    t.set_value(np.ones_like(X))
    assert t.value is storage            # a leaf keeps its storage
    j.set_value(np.ones_like(X))
    compare(t.numpy(), np.asarray(j._value), EXACT, "set_value")
    with pytest.raises(ValueError):
        t.set_value(np.ones((2, 2), np.float32))


@pytest.mark.parametrize("alias,args", [
    ("add_", (X[::-1].copy(),)), ("subtract_", (X[::-1].copy(),)),
    ("multiply_", (X[::-1].copy(),)), ("scale_", (2.0, 0.5)),
    ("clip_", (-0.5, 0.5)), ("zero_", ()), ("fill_", (1.25,))])
def test_inplace_aliases_match_reference(alias, args):
    j, t = _pair()
    jargs = [jp.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    targs = [pt.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    storage = t.value
    assert getattr(t, alias)(*targs) is t
    getattr(j, alias)(*jargs)
    compare(t.numpy(), np.asarray(j._value), F32, alias)
    assert t.value is storage


def test_setitem_matches_reference_and_carries_gradients():
    j, t = _pair()
    j[1] = 5.0
    t[1] = 5.0
    j[:, 2] = jp.to_tensor(np.arange(3, dtype=np.float32))
    t[:, 2] = pt.to_tensor(np.arange(3, dtype=np.float32))
    j[0, 0] = np.float32(-1.0)
    t[0, 0] = np.float32(-1.0)
    compare(t.numpy(), np.asarray(j._value), EXACT, "__setitem__")
    for pkg in (jp, pt):
        x = pkg.to_tensor(X, stop_gradient=False)
        y = x * 2.0
        y[0] = 0.0
        y.sum().backward()
        g = to_numpy(x.grad)
        np.testing.assert_array_equal(g[0], 0.0)
        np.testing.assert_array_equal(g[1:], 2.0)


def test_inplace_on_a_trainable_parameter():
    """``param.scale_(...)`` raises while grad is recorded (torch's and
    paddle's rule), and under ``no_grad`` writes the parameter's own
    storage: the values the JAX package's writes give, and the parameter
    stays trainable, so the next SGD step updates the tensor the layer
    uses (the JAX package adopts the op's result, which leaves its
    parameter with ``stop_gradient`` set and no gradient: ROADMAP
    "Known facts about the reference")."""
    jlin = jp.nn.Linear(3, 2)
    tlin = pt.nn.Linear(3, 2)
    for k, v in jlin.state_dict().items():
        tlin.state_dict()[k].set_value(np.asarray(v._value))
    storage = tlin.weight.value
    with pytest.raises(InvalidArgumentError, match="no_grad"):
        tlin.weight.scale_(2.0)
    with pytest.raises(InvalidArgumentError, match="no_grad"):
        tlin.weight[0] = 1.0
    for P, lin in ((jp, jlin), (pt, tlin)):
        with P.no_grad():
            lin.weight.scale_(2.0)
            lin.weight[0, 0] = 0.5
    written = tlin.weight.numpy()
    compare(written, np.asarray(jlin.weight._value), EXACT, "written")
    assert not tlin.weight.stop_gradient and tlin.weight.value is storage
    opt = pt.optimizer.SGD(0.1, parameters=tlin.parameters())
    tlin(pt.to_tensor(X[:, :3].copy())).sum().backward()
    grad = tlin.weight.grad.numpy()
    opt.step()
    assert tlin.weight.value is storage
    compare(tlin.weight.numpy(), written - np.float32(0.1) * grad, F32,
            "stepped")


def test_register_hook_scales_the_gradient_and_is_removable():
    grads = {}
    for pkg in (jp, pt):
        x = pkg.to_tensor(X, stop_gradient=False)
        y = x * 1.0
        h = y.register_hook(lambda g: g * 3.0)
        y.sum().backward()
        grads[pkg.__name__] = to_numpy(x.grad)
        h.remove()
    compare(grads["paddle_tpu_torch"], grads["paddle_tpu"], EXACT, "hook")
    x = pt.to_tensor(X, stop_gradient=False)
    y = x * 1.0
    y.register_hook(lambda g: g * 3.0).remove()
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), 1.0)


def test_method_forms_are_the_op_functions():
    from paddle_tpu_torch.ops import linalg, logic, manipulation, math, search

    skip = {"cond", "is_tensor", "broadcast_shape"}
    n = 0
    for mod in (math, manipulation, logic, search, linalg):
        for name in mod.__all__:
            if name in skip:
                continue
            assert getattr(pt.Tensor, name) is getattr(mod, name), name
            n += 1
    assert n > 200
    j, t = _pair()
    compare(t.exp().numpy(), np.asarray(j.exp()._value), F32, "exp")
    compare(t.topk(2)[1].numpy(), np.asarray(j.topk(2)[1]._value), EXACT,
            "topk")
    compare(t.matmul(t.t()).numpy(), np.asarray(j.matmul(j.t())._value),
            (1e-5, 1e-5), "matmul")
    assert pt.VarBase is pt.Tensor and pt.LoDTensor is pt.Tensor


def test_autograd_grad_and_backward_match_reference():
    res = {}
    for pkg in (jp, pt):
        x = pkg.to_tensor(X, stop_gradient=False)
        y = (x * x * x).sum()
        (g,) = pkg.grad(y, x, create_graph=True)
        (gg,) = pkg.grad(g.sum(), x)
        z = pkg.to_tensor(X, stop_gradient=False)
        pkg.autograd.backward([(z * z).sum()], [pkg.to_tensor(
            np.array(2.0, np.float32))])
        res[pkg.__name__] = [to_numpy(g), to_numpy(gg), to_numpy(z.grad)]
    compare(res["paddle_tpu_torch"], res["paddle_tpu"], F32, "grad")
    x = pt.to_tensor(X, stop_gradient=False)
    other = pt.to_tensor(X, stop_gradient=False)
    assert pt.grad((x * 2).sum(), [x, other], allow_unused=True)[1] is None


def test_grad_modes():
    x = pt.to_tensor(X, stop_gradient=False)
    with pt.no_grad():
        assert (x * 2).stop_gradient
        assert not pt.is_grad_enabled()
        with pt.enable_grad():
            assert not (x * 2).stop_gradient
    with pt.set_grad_enabled(False):
        assert (x * 2).stop_gradient
    assert pt.is_grad_enabled() and pt.is_grad_enabled_()


def test_dtypes_and_places():
    for name in ("bool_", "uint8", "int8", "int16", "int32", "int64",
                 "float16", "bfloat16", "float32", "float64", "complex64",
                 "complex128"):
        d = getattr(pt, name)
        assert isinstance(d, torch.dtype)
        assert pt.framework.dtype_name(d) == (
            "bool" if name == "bool_" else name)
    assert pt.bool_ is torch.bool
    assert pt.framework.convert_dtype("bfloat16") is torch.bfloat16
    assert pt.framework.convert_dtype(np.int32) is torch.int32
    assert pt.framework.is_integer("int64") and not pt.framework.is_integer(
        pt.float32)
    assert pt.get_default_dtype() is torch.float32
    assert pt.CPUPlace() == pt.CPUPlace() and pt.CUDAPlace(1) != \
        pt.CUDAPlace(0)
    assert repr(pt.CUDAPlace(2)) == "CUDAPlace(2)"
    assert pt.CUDAPlace(3).get_device_id() == 3
    assert pt.to_tensor(X, place=pt.CPUPlace()).place.type == "cpu"
    assert pt.to_tensor(X, place=pt.CUDAPinnedPlace()).place.type == "cpu"
    for p in (pt.TPUPlace(0), pt.XPUPlace(0)):
        with pytest.raises(InvalidArgumentError):
            pt.to_tensor(X, place=p)
        with pytest.raises(InvalidArgumentError):
            pt.set_device(p)
    assert pt.get_device() == "cpu"
    assert not pt.is_compiled_with_tpu() and not pt.is_compiled_with_xpu()
    assert pt.is_compiled_with_cuda() == (torch.version.cuda is not None)
    assert pt.framework.default_place() == pt.CPUPlace()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            pt.to_tensor(X, place=pt.CUDAPlace(0))


def test_flags_match_reference():
    assert pt.get_flags("FLAGS_check_nan_inf") == \
        jp.get_flags("FLAGS_check_nan_inf")
    pt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="NaN or Inf"):
            pt.log(pt.to_tensor(np.array([-1.0], np.float32)))
    finally:
        pt.set_flags({"FLAGS_check_nan_inf": False})
    with pytest.raises(KeyError):
        pt.get_flags("FLAGS_no_such_flag")


def test_flags_are_acted_on_or_refused():
    """``cudnn_deterministic`` and ``tpu_matmul_precision`` set torch's
    switches; a flag the port does not act on takes only its default."""
    det = torch.backends.cudnn.deterministic
    prec = torch.get_float32_matmul_precision()
    conv_tf32 = torch.backends.cudnn.allow_tf32
    try:
        pt.set_flags({"FLAGS_cudnn_deterministic": True})
        assert torch.backends.cudnn.deterministic
        pt.set_flags({"FLAGS_tpu_matmul_precision": "highest"})
        assert torch.get_float32_matmul_precision() == "highest"
        assert not torch.backends.cudnn.allow_tf32
        pt.set_flags({"FLAGS_tpu_matmul_precision": "high"})
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32
        with pytest.raises(InvalidArgumentError):
            pt.set_flags({"FLAGS_tpu_matmul_precision": "medium"})
        assert pt.get_flags("FLAGS_tpu_matmul_precision") == {
            "FLAGS_tpu_matmul_precision": "high"}
    finally:
        pt.set_flags({"FLAGS_cudnn_deterministic": False,
                      "FLAGS_tpu_matmul_precision": "default"})
        torch.backends.cudnn.deterministic = det
        torch.set_float32_matmul_precision(prec)
        torch.backends.cudnn.allow_tf32 = conv_tf32
    for name, value in (("FLAGS_seed", 5), ("FLAGS_benchmark", True),
                        ("FLAGS_fraction_of_gpu_memory_to_use", 0.5)):
        default = pt.get_flags(name)[name]
        with pytest.raises(InvalidArgumentError,
                           match="does not act"):
            pt.set_flags({name: value})
        assert pt.get_flags(name)[name] == default
        pt.set_flags({name: default})


@pytest.mark.parametrize("name,args,kw", [
    ("elementwise_add", [X, X[0].copy()], {}),
    ("elementwise_add", [X, X[:, 0].copy()], {"axis": 0}),
    ("elementwise_mul", [X, X[:, 1].copy()], {"axis": 0}),
    ("elementwise_sub", [X, X], {}), ("elementwise_div", [X, X + 3], {}),
    ("elementwise_pow", [np.abs(X), X], {}),
    ("elementwise_mod", [X, X * 0 + 0.7], {}),
    ("elementwise_floordiv", [X, X * 0 + 0.7], {}),
    ("reduce_sum", [X], {"dim": 1, "keep_dim": True}),
    ("reduce_mean", [X], {"dim": 0}), ("reduce_max", [X], {}),
    ("reduce_min", [X], {"dim": [0, 1]}), ("reduce_prod", [X], {"dim": 1}),
    ("cast", [X], {"dtype": "int32"}), ("mv", [X, X[0].copy()], {}),
    ("addmm", [X[:, :3].copy(), X, X.T[:, :3].copy()], {"beta": 0.5,
                                                        "alpha": 2.0}),
    ("rank", [X], {}), ("shape", [X], {}), ("has_inf", [X], {}),
    ("has_nan", [X], {}), ("fill_constant", [[2, 2], "float32", 3.5], {}),
    ("crop_tensor", [X], {"shape": [2, -1], "offsets": [1, 1]}),
    ("tanh_", [X.copy()], {}), ("scatter_", [X.copy(), np.array(
        [2, 0], np.int32), X[:2].copy()], {})])
def test_compat_name_matches_reference(name, args, kw):
    from torch_op_parity import run_both

    got, want = run_both(name, args, kw)
    compare(got, want, (1e-5, 1e-6), name)


def test_compat_helpers():
    assert pt.get_cudnn_version() is None or isinstance(
        pt.get_cudnn_version(), int)
    state = pt.get_cuda_rng_state()
    pt.set_cuda_rng_state(state)
    pt.monkey_patch_math_varbase()
    pt.monkey_patch_variable()
    assert isinstance(pt.LoDTensorArray(), list)
    pt.set_printoptions(precision=4)
    np.set_printoptions(precision=8)
    net = pt.nn.Linear(8, 4)
    assert pt.flops(net, [2, 8]) == 2 * 2 * 8 * 4


def test_save_and_load_place_tensors_on_the_default_place(tmp_path):
    t = pt.to_tensor(X)
    p = str(tmp_path / "t.pdparams")
    pt.save({"w": t, "n": 3, "l": [t]}, p)
    out = pt.load(p)
    assert out["w"].place.type == "cpu" and out["n"] == 3
    compare(out["l"][0].numpy(), X, EXACT, "load")
    assert isinstance(pt.load(p, return_numpy=True)["w"], np.ndarray)
    if not torch.cuda.is_available():
        place._DEFAULT["device"] = None     # the card: absent here
        with pytest.raises(RuntimeError, match="is_available"):
            pt.load(p)
        place._DEFAULT["device"] = torch.device("cpu")
    # a file written by either package loads in the other
    jpath = str(tmp_path / "j.pdparams")
    jp.save({"w": jp.to_tensor(X)}, jpath)
    compare(pt.load(jpath)["w"].numpy(), X, EXACT, "jax -> port")
    compare(np.asarray(jp.load(p)["w"]._value), X, EXACT, "port -> jax")


def test_utils_surface():
    from paddle_tpu_torch import utils

    assert utils.run_check("cpu") is True
    assert utils.try_import("json") is not None
    assert utils.try_import("no_such_module_here") is None
    assert utils.deprecated(since="2.0")(len) is len
    utils.require_version("0.0.1")
    with pytest.raises(Exception):
        utils.require_version("99.0")
    with utils.unique_name.guard():
        assert utils.unique_name.generate("fc") == "fc_0"
        assert utils.unique_name.generate("fc") == "fc_1"
    assert utils.ProfilerOptions({"state": "GPU"})["state"] == "GPU"
