"""The port's tape semantics against the JAX package's, on the CPU:

- the comparison operators (fault C1): ``==``, ``!=``, ``<``, ``<=``,
  ``>``, ``>=`` give elementwise bool Tensors, with a Tensor, a scalar
  and a reflected operand; ``in`` over a list of Tensors raises as the
  reference's does; ``__hash__`` is identity; the accuracy line of a
  training loop gives the reference's number;
- the in-place version guard (fault C2): the cases of
  ``tests/test_tensor_autograd.py:314-353`` and the ``y.add_(y)`` case
  raise, or give the reference's gradients, as the reference does; an
  ``optimizer.step()`` between the forward and the backward stays legal
  and uses the recorded values;
- ``inplace_version`` (fault C3) counts the writes of a rebound tensor;
- ``autograd.run_backward`` and ``GradNode``; the process init and the
  op version registry.

Tolerances: the comparisons and versions exact; gradients 1e-6
relative (f32, a few products)."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pt
from torch_layer_parity import one_torch_thread_on_the_cpu

RTOL = dict(rtol=1e-6, atol=0)


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


A, B = np.array([1, 2, 3], np.int64), np.array([1, 0, 3], np.int64)
OPS = {
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
}
OPERANDS = {
    "tensor": lambda pkg: pkg.to_tensor(B),
    "scalar": lambda pkg: 2,
}


@pytest.mark.parametrize("operand", sorted(OPERANDS))
@pytest.mark.parametrize("op", sorted(OPS))
def test_comparison_is_elementwise(op, operand):
    out = {}
    for name, pkg in (("ref", jp), ("port", pt)):
        a = pkg.to_tensor(A)
        other = OPERANDS[operand](pkg)
        res = OPS[op](a, other)
        reflected = OPS[op](other, a)
        assert isinstance(res, pkg.Tensor) and isinstance(reflected,
                                                          pkg.Tensor)
        out[name] = (np.asarray(res.numpy()), np.asarray(reflected.numpy()))
    for r, p in zip(out["ref"], out["port"]):
        assert p.dtype == np.bool_
        np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("pkg", [jp, pt], ids=["ref", "port"])
def test_membership_compares_elementwise_and_hash_is_identity(pkg):
    a, b = pkg.to_tensor(A), pkg.to_tensor(B)
    with pytest.raises(ValueError):
        b in [a, b]            # noqa: B015 — elementwise, then bool()
    assert hash(a) == id(a) or hash(a) == object.__hash__(a)
    assert {a: 1, b: 2}[b] == 2
    assert a in {a} and b not in {a}


@pytest.mark.parametrize("form", ["astype", "cast"])
def test_accuracy_line(form):
    vals = {}
    for name, pkg in (("ref", jp), ("port", pt)):
        pred = pkg.to_tensor(np.array([1, 2, 3], np.int64))
        label = pkg.to_tensor(np.array([1, 2, 3], np.int64))
        hit = pred == label
        acc = (hit.astype("float32").mean() if form == "astype"
               else pkg.cast(hit, "float32").mean())
        vals[name] = float(acc.numpy())
    assert vals["port"] == vals["ref"] == 1.0


# --- the in-place version guard ------------------------------------------
def _intermediate_after_record(pkg):
    x = pkg.to_tensor(np.ones((3,), np.float32))
    x.stop_gradient = False
    h = x * 2.0
    y = h * h
    h[0] = 9.0
    y.sum().backward()
    return x


def _leaf_step_between_record_and_backward(pkg):
    x = pkg.to_tensor(np.full((3,), 2.0, np.float32))
    x.stop_gradient = False
    y = x * x
    x.set_value(pkg.to_tensor(np.full((3,), 5.0, np.float32)))
    y.sum().backward()
    return x


def _inplace_before_record(pkg):
    x = pkg.to_tensor(np.ones((3,), np.float32))
    x.stop_gradient = False
    x.set_value(pkg.to_tensor(np.full((3,), 2.0, np.float32)))
    y = x * x
    y.sum().backward()
    return x


def _add_to_itself_after_record(pkg):
    x = pkg.to_tensor(np.array([1.0, 2.0], np.float32))
    x.stop_gradient = False
    y = x * 2
    z = y.exp()
    y.add_(y)
    z.sum().backward()
    return x


def _adopted_op_refreshes_its_note(pkg):
    x = pkg.to_tensor(np.array([1.0, 2.0], np.float32))
    x.stop_gradient = False
    y = x * 2
    y.add_(pkg.to_tensor(np.float32(1.0)))
    (y * 3).sum().backward()
    return x


GUARD_CASES = {
    "intermediate_after_record": (_intermediate_after_record, True),
    "leaf_step_between_record_and_backward": (
        _leaf_step_between_record_and_backward, False),
    "inplace_before_record": (_inplace_before_record, False),
    "add_to_itself_after_record": (_add_to_itself_after_record, True),
    "adopted_op_refreshes_its_note": (_adopted_op_refreshes_its_note, False),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_inplace_version_guard(case):
    fn, raises = GUARD_CASES[case]
    if raises:
        for pkg in (jp, pt):
            with pytest.raises(RuntimeError, match="in-place"):
                fn(pkg)
        return
    ref, port = fn(jp), fn(pt)
    np.testing.assert_allclose(port.grad.numpy(), np.asarray(ref.grad.numpy()),
                               **RTOL)


def test_optimizer_step_between_record_and_backward_is_legal():
    """A parameter updated after an op saved it: the backward uses the
    value the op saw, as the reference's immutable arrays do."""
    grads = {}
    for name, pkg in (("ref", jp), ("port", pt)):
        w = pkg.to_tensor(np.array([1.5, -2.0, 0.5], np.float32))
        w.stop_gradient = False
        opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=[w])
        y1 = (w * w).sum()
        y2 = (w * w * w).sum()
        y1.backward()
        opt.step()
        opt.clear_grad()
        y2.backward()
        grads[name] = (np.asarray(w.grad.numpy()), np.asarray(w.numpy()))
    for r, p in zip(grads["ref"], grads["port"]):
        np.testing.assert_allclose(p, r, **RTOL)


@pytest.mark.parametrize("writes", [0, 1, 2, 3])
def test_inplace_version_counts_rebinding_writes(writes):
    seen = {}
    for name, pkg in (("ref", jp), ("port", pt)):
        x = pkg.to_tensor(np.array([1.0, 2.0], np.float32))
        x.stop_gradient = False
        y = x * 2
        for _ in range(writes):
            y.add_(pkg.to_tensor(np.float32(1.0)))
        seen[name] = y.inplace_version
    assert seen["port"] == seen["ref"] == writes


@pytest.mark.parametrize("write", ["set_value", "setitem", "scale_",
                                   "zero_"])
def test_each_inplace_form_bumps_the_version(write):
    seen = {}
    for name, pkg in (("ref", jp), ("port", pt)):
        x = pkg.to_tensor(np.array([1.0, 2.0], np.float32))
        if write == "set_value":
            x.set_value(np.array([3.0, 4.0], np.float32))
        elif write == "setitem":
            x[0] = 5.0
        elif write == "scale_":
            x.scale_(2.0)
        else:
            x.zero_()
        seen[name] = (x.inplace_version, np.asarray(x.numpy()))
    assert seen["port"][0] == seen["ref"][0] == 1
    np.testing.assert_array_equal(seen["port"][1], seen["ref"][1])


def test_optimizer_step_bumps_the_parameter_version():
    seen = {}
    for name, pkg in (("ref", jp), ("port", pt)):
        lin = pkg.nn.Linear(2, 2)
        opt = pkg.optimizer.SGD(0.1, parameters=lin.parameters())
        lin(pkg.ones([1, 2])).sum().backward()
        opt.step()
        seen[name] = lin.weight.inplace_version
    assert seen["port"] == seen["ref"] == 1


# --- run_backward and GradNode --------------------------------------------
def _graph(pkg, w_twice=True):
    x = pkg.to_tensor(np.array([0.5, -1.0, 2.0], np.float32))
    w = pkg.to_tensor(np.array([1.5, 0.25, -0.75], np.float32))
    x.stop_gradient = False
    w.stop_gradient = False
    e = (x * w).exp()
    loss = (e * w).sum() if w_twice else (e * e).sum()
    return x, w, loss


RUN_BACKWARD = {
    "into_grads": dict(),
    "twice_accumulates": dict(twice=True),
    "twice_replaces": dict(twice=True, accumulate=False, w_twice=False),
    "inputs": dict(inputs=True),
    "seeded": dict(seed=np.float32(3.0)),
}


@pytest.mark.parametrize("case", sorted(RUN_BACKWARD))
def test_run_backward(case):
    kw = RUN_BACKWARD[case]
    out = {}
    for name, pkg in (("ref", jp), ("port", pt)):
        x, w, loss = _graph(pkg, kw.get("w_twice", True))
        seed = kw.get("seed")
        seeds = None if seed is None else [pkg.to_tensor(seed)]
        if kw.get("inputs"):
            gs = pkg.autograd.run_backward([loss], seeds, inputs=[x, w])
            assert x.grad is None and w.grad is None
            out[name] = [np.asarray(g.numpy()) for g in gs]
            continue
        for _ in range(2 if kw.get("twice") else 1):
            pkg.autograd.run_backward([loss], seeds, retain_graph=True,
                                      accumulate=kw.get("accumulate", True))
        out[name] = [np.asarray(x.grad.numpy()), np.asarray(w.grad.numpy())]
    for r, p in zip(out["ref"], out["port"]):
        np.testing.assert_allclose(p, r, **RTOL)


def test_run_backward_replacing_keeps_the_whole_gradient():
    """``accumulate=False`` gives a leaf the whole gradient of that
    backward; the reference keeps only the last of the pieces a leaf
    used by two ops receives (ROADMAP "Known facts about the
    reference")."""
    x, w, loss = _graph(pt)
    pt.autograd.run_backward([loss], retain_graph=True)
    once = w.grad.numpy()
    pt.autograd.run_backward([loss], retain_graph=True, accumulate=False)
    np.testing.assert_array_equal(w.grad.numpy(), once)
    jx, jw, jloss = _graph(jp)
    jp.autograd.run_backward([jloss], retain_graph=True, accumulate=False)
    last_piece = np.asarray((jw * jx * (jx * jw).exp()).numpy())
    np.testing.assert_allclose(np.asarray(jw.grad.numpy()), last_piece,
                               **RTOL)


def test_run_backward_equals_backward_and_refuses_an_implicit_nonscalar():
    x, w, loss = _graph(pt)
    pt.autograd.run_backward([loss], retain_graph=True)
    g1 = x.grad.numpy()
    x.clear_grad()
    loss.backward()
    np.testing.assert_array_equal(x.grad.numpy(), g1)
    for pkg in (jp, pt):
        x, w, _ = _graph(pkg)
        with pytest.raises(RuntimeError, match="scalar"):
            pkg.autograd.run_backward([x * w])
        with pytest.raises(RuntimeError, match="allow_unused"):
            pkg.autograd.run_backward([(x * 2).sum()], inputs=[x, w])
        gx, gw = pkg.autograd.run_backward([(x * 2).sum()], inputs=[x, w],
                                           allow_unused=True)
        assert gw is None
        np.testing.assert_array_equal(np.asarray(gx.numpy()), 2.0)


def test_grad_node_view():
    x, w, loss = _graph(pt)
    node = pt.autograd.GradNode(loss)
    assert node.name.endswith("Backward0") or "Backward" in node.name
    assert all(e is None or isinstance(e, pt.autograd.GradNode)
               for e in node.edges)
    node.release()
    assert node.name is None and node.edges == []
    assert pt.autograd.GradNode(x).name is None


# --- framework init and op versions ---------------------------------------
def test_framework_init_and_op_versions():
    from paddle_tpu.framework import op_version as jop
    from paddle_tpu_torch.framework import init as tinit
    from paddle_tpu_torch.framework import op_version as top

    devices = tinit.init_devices()
    assert tinit.init_devices() is devices and tinit.is_initialized()
    assert tinit.get_platform() == "cpu"
    assert top.op_version_registry.version_map() == \
        jop.op_version_registry.version_map()
    assert top.op_version_registry.check_compat({"dropout": 0}) == \
        jop.op_version_registry.check_compat({"dropout": 0})
    assert pt.utils.OpLastCheckpointChecker().get_op_attrs("dropout") == \
        jp.utils.OpLastCheckpointChecker().get_op_attrs("dropout")
    calls = []
    tinit.register_shutdown_hook(lambda: calls.append(1))
    assert tinit._sigterm_hooks[-1] is not None
    tinit._sigterm_hooks.pop()
