"""paddle_tpu_torch.jit.to_static and its dy2static pass against
paddle_tpu.jit.

The twins of ``tests/test_dy2static_ast.py`` and the ``to_static`` half
of ``tests/test_dy2static_loud.py``: every accepted program gives the
same outputs in both packages (f32 on the CPU, rtol 1e-6 — the same
elementwise ops on the same inputs) and every refused one raises the same
error type with the same message fragment.  The case functions are
shared module-level functions (each package converts them with its own
cache); the Layer cases carry the JAX package's weights across.  The
``to_static`` half of ``tests/test_end_to_end.py`` (linear outputs, grads
flow) is in ``tests/test_torch_end_to_end.py``.
"""
import re
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import control_flow as jcf
from paddle_tpu.jit.dy2static import ProgramTranslator as JaxTranslator

import paddle_tpu_torch as pt
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.jit import control_flow as tcf
from paddle_tpu_torch.jit.dy2static import ProgramTranslator, \
    convert_function
from paddle_tpu_torch.nn.layer import state_from_numpy
from paddle_tpu_torch.profiler.jit_cost import compile_budget

PKG = {"jax": (paddle, jjit, jcf), "torch": (pt, tjit, tcf)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small ops on one thread: the suite's workers share the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def _t(api, a, dtype=np.float32):
    return api.to_tensor(np.asarray(a, dtype))


# --- accepted programs (tests/test_dy2static_ast.py) -----------------------

def early_return(x):
    if x.sum() > 0:
        return x * 2.0
    return -x


def if_else_both_return(x):
    if x.mean() > 1.0:
        y = x - 1.0
        return y * y
    else:
        return x + 10.0


def assignment_form(x):
    scale = 1.0
    if x.sum() > 0:
        scale = 2.0
        y = x * scale
    else:
        y = x - 1.0
    return y + scale


def elif_chain(x):
    s = x.sum()
    if s > 10.0:
        return x * 3.0
    elif s > 0.0:
        return x * 2.0
    else:
        return -x


def var_defined_inside(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = -x
    return y


def python_bool_if(x, double):
    if double:
        x = x * 2.0
    return x


def while_accumulate(x):
    while x.sum() < 10.0:
        x = x + 1.0
    return x


def while_two_vars(x):
    total = x - x
    while x.sum() > 0.0:
        total = total + x
        x = x - 1.0
    return total


def for_range_tensor_bound(x, n):
    acc = x - x
    for i in range(n):
        acc = acc + x
    return acc


def for_range_python_bound(x):
    for _ in range(3):
        x = x * 2.0
    return x


def traced_and_or_not(x, y):
    if (x > 0 and y > 0) or not (x < 10):
        return x + y
    return x - y


def not_on_while_condition(x):
    i = x * 0.0
    while not (i >= x):
        i = i + 1.0
    return i


def mixed_concrete_and(x, use_gate):
    if use_gate and x.sum() > 0:
        return x * 2.0
    return x


def or_returns_operand(x):
    cfg = None
    w = cfg or x
    return x * w


def and_returns_operand(x):
    scale = 2.0
    s = scale and x
    if x.sum() > 0 and not (x.sum() > 100):
        return s + 1.0
    return s


def control_flow_cond(x, cf):
    return cf.cond(x.sum() > 0, lambda: x * 2.0, lambda: -x)


def control_flow_while(x, cf):
    out, = cf.while_loop(lambda v: v.sum() < 10.0, lambda v: (v + 1.0,),
                         (x,))
    return out


ACCEPTED = [
    (early_return, [[1.0, 2.0]], ()),
    (early_return, [[-1.0, -2.0]], ()),
    (if_else_both_return, [[2.0, 4.0]], ()),
    (if_else_both_return, [[0.0, 1.0]], ()),
    (assignment_form, [[1.0, 2.0]], ()),
    (assignment_form, [[-3.0]], ()),
    (elif_chain, [[20.0]], ()),
    (elif_chain, [[3.0]], ()),
    (elif_chain, [[-1.0]], ()),
    (var_defined_inside, [[1.0]], ()),
    (var_defined_inside, [[-1.0]], ()),
    (python_bool_if, [[1.0]], (True,)),
    (python_bool_if, [[1.0]], (False,)),
    (while_accumulate, [[0.0]], ()),
    (while_accumulate, [[7.5]], ()),
    (while_two_vars, [[3.0]], ()),
    (for_range_tensor_bound, [[1.5], np.int32(4)], ()),
    (for_range_python_bound, [[1.0]], ()),
    (traced_and_or_not, [2.0, 3.0], ()),
    (traced_and_or_not, [-2.0, 3.0], ()),
    (traced_and_or_not, [11.0, 3.0], ()),
    (not_on_while_condition, [4.0], ()),
    (mixed_concrete_and, [[1.0, 2.0]], (True,)),
    (mixed_concrete_and, [[1.0, 2.0]], (False,)),
    (or_returns_operand, [[2.0, 3.0]], ()),
    (and_returns_operand, [[2.0, 3.0]], ()),
    (control_flow_cond, [[1.0, 2.0]], ("cf",)),
    (control_flow_cond, [[-1.0, -2.0]], ("cf",)),
    (control_flow_while, [[0.0, 0.0]], ("cf",)),
]


def _run(pkg, fn, arrays, statics):
    api, jit, cf = PKG[pkg]
    tensors = [_t(api, a, np.int32 if isinstance(a, np.integer)
                  else np.float32) for a in arrays]
    extra = [cf if s == "cf" else s for s in statics]
    return jit.to_static(fn)(*tensors, *extra).numpy()


@pytest.mark.parametrize("fn,arrays,statics", ACCEPTED,
                         ids=[f"{c[0].__name__}-{i}" for i, c in
                              enumerate(ACCEPTED)])
def test_accepted_program_matches_jax(fn, arrays, statics):
    want = _run("jax", fn, arrays, statics)
    got = _run("torch", fn, arrays, statics)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --- refused programs (tests/test_dy2static_loud.py) -----------------------

def unconvertible_if(x):
    state = types.SimpleNamespace(v=0.0)
    if (x.sum() > 0):
        state.v = 1.0        # attribute store: out of the subset
        x = x + state.v
    return x


def unconvertible_while(x):
    while (x.sum() < 10.0):
        x = x + 1.0
        if x.max() > 100.0:
            break            # owns a break: out of the subset
    return x


def int_coercion(x):
    n = int(x.sum())
    return x * n


def python_counter_in_while(x):
    i = 0
    while x.sum() < 4.0:
        i = i + 1
        x = x + 1.0
    return x


def break_at_five(x):
    while x.sum() < 10.0:
        x = x + 1.0
        if x.max() > 5.0:
            break
    return x


REFUSED = [
    (unconvertible_if, [[1.0, 2.0]], TypeError, "control_flow.cond"),
    (unconvertible_while, [[0.0]], TypeError, "control_flow"),
    (int_coercion, [[3.0]], TypeError, "traced Tensor"),
    (python_counter_in_while, [[0.0]], TypeError, "loop variable"),
    (break_at_five, [[0.0]], TypeError, None),
]


@pytest.mark.parametrize("fn,arrays,err,match", REFUSED,
                         ids=[c[0].__name__ for c in REFUSED])
def test_refused_program_raises_like_jax(fn, arrays, err, match):
    for pkg in PKG:
        with pytest.raises(err, match=match):
            _run(pkg, fn, arrays, ())


def test_eager_coercion_still_works():
    x = _t(pt, [1.0, 2.0])
    assert bool(x.sum() > 0) and float(x.sum()) == 3.0


# --- Layers, gradients, the cache -----------------------------------------

def _gate(pkg):
    api, jit, _ = PKG[pkg]
    nn = jnn if pkg == "jax" else tnn

    class Gate(nn.Layer):
        def __init__(self):
            nn.Layer.__init__(self)
            self.fc = nn.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.mean() > 0.0:
                out = h * 2.0
            else:
                out = -h
            return out.sum()

    return Gate()


def test_grads_flow_through_converted_control_flow():
    paddle.seed(0)
    nets = {pkg: _gate(pkg) for pkg in PKG}
    nets["torch"].set_state_dict(state_from_numpy(
        {k: np.asarray(v._value) for k, v in
         nets["jax"].state_dict().items()}, "cpu"))
    xv = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    losses = {}
    for pkg, net in nets.items():
        api, jit, _ = PKG[pkg]
        O = jopt if pkg == "jax" else topt
        net = jit.to_static(net)
        opt = O.SGD(0.1, parameters=net.parameters())
        losses[pkg] = []
        for _ in range(5):
            loss = net(_t(api, xv))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses[pkg].append(float(loss.numpy()))
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    assert losses["torch"][-1] != losses["torch"][0]


class TinyRNN(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.cell = tnn.Linear(8, 4)

    def forward(self, x, steps):
        h = pt.zeros([x.shape[0], 4], dtype="float32")
        for i in range(steps):
            h = pt.tanh(self.cell(pt.concat([x, h], axis=-1)))
        return h.sum()


def test_rnn_style_for_loop_trains():
    net = tjit.to_static(TinyRNN())
    loss = net(_t(pt, np.random.RandomState(1).randn(2, 4)), 3)
    loss.backward()
    g = net.cell.weight.grad
    assert g is not None and float(np.abs(g.numpy()).sum()) > 0


def test_signature_cache_and_ledger():
    f = tjit.to_static(early_return)
    with compile_budget(None) as cb:
        f(_t(pt, [1.0, 2.0]))
        f(_t(pt, [-1.0, 5.0]))          # same signature: no new program
        f(_t(pt, [1.0, 2.0, 3.0]))      # new shape
    assert len(f.concrete_programs) == 2
    assert sum(cb.compiles().values()) == 2


def test_to_static_on_bound_method_and_layer():
    class Net(tnn.Layer):
        def __init__(self):
            tnn.Layer.__init__(self)
            self.fc = tnn.Linear(4, 2)

        def forward(self, x):
            if x.mean() > 0 and not (x.std() < 1e-6):
                return self.fc(x) * 2.0
            return self.fc(x)

    net = Net()
    v = np.ones((3, 4), np.float32)
    ref = net.fc(_t(pt, v)).numpy()
    f = tjit.to_static(net.forward)
    np.testing.assert_allclose(f(_t(pt, v)).numpy(), ref, rtol=1e-6)
    tjit.to_static(net)
    assert isinstance(net.forward, tjit.StaticFunction)
    np.testing.assert_allclose(net(_t(pt, v)).numpy(), ref, rtol=1e-6)


def test_not_to_static_is_left_alone():
    @tjit.not_to_static
    def g(x):
        return x + 1.0

    assert tjit.to_static(g) is g


class TestConvertFunction:
    def test_conversion_reported(self):
        conv, did = convert_function(early_return)
        assert did and conv is not early_return

    def test_no_control_flow_not_converted(self):
        def f(x):
            return x * 2.0

        conv, did = convert_function(f)
        assert not did and conv is f

    def test_python_semantics_preserved_eagerly(self):
        def f(x, k):
            acc = 0.0
            for i in range(k):
                if i % 2 == 0:
                    acc = acc + float(x[i])
                else:
                    acc = acc - float(x[i])
            return acc

        conv, _ = convert_function(f)
        x = np.asarray([1.0, 2.0, 3.0], np.float32)
        assert conv(x, 3) == f(x, 3) == 1.0 - 2.0 + 3.0

    def test_concrete_value_semantics_preserved(self):
        def g(flag):
            calls = []

            def boom():
                calls.append(1)
                return True

            r1 = 0 and boom()
            r2 = 3 and 5
            r3 = 0 or "x"
            r4 = not flag
            return r1, r2, r3, r4, calls

        conv, did = convert_function(g)
        assert did and conv(True) == (0, 5, "x", False, [])

    def test_walrus_operand_left_untouched(self):
        def h(x):
            if (n := x + 1) and n > 1:
                return n
            return 0

        conv, _ = convert_function(h)
        assert conv(5) == 6

    @pytest.mark.parametrize("fn", [early_return, assignment_form,
                                    while_two_vars, traced_and_or_not,
                                    for_range_tensor_bound])
    def test_get_code_equals_jax(self, fn):
        """The same AST pass: the transformed source is the JAX
        package's, up to the per-process counter in helper names."""
        def norm(code):
            return re.sub(r"_ptpu_(\w+?)\d+", r"_ptpu_\1N", code)

        got = ProgramTranslator.get_instance().get_code(fn)
        want = JaxTranslator.get_instance().get_code(fn)
        assert "_ptpu_dy2s" in got and norm(got) == norm(want)
