"""The port's math ops (``paddle_tpu_torch/ops/math.py``) against
``paddle_tpu/ops/math.py`` on the CPU: each op one case, the same seeded
numpy inputs through ``paddle_tpu.<op>`` and ``paddle_tpu_torch.<op>``
(the top-level namespace both packages export).

Tolerances: integer, logical and exact-by-construction ops (``floor``,
``max``, ``sign``, ...) are compared exactly; f32 elementwise ops,
reductions and scans within 1e-6 relative and 1e-6 absolute (XLA's and
ATen's f32 kernels of the same function differ by a few ulp).  Looser,
with the reason beside it: the special functions (``lgamma``,
``digamma``, ``erfinv``: different polynomial approximations) 1e-5.
The cases named in the port's docstrings as where parity is likely to
break are here: ``median`` of an even count (the mean of the two middle
values), ``mod`` / ``remainder`` / ``floor_mod`` of negative operands
(floor-mod), ``cummax`` / ``cummin`` ties (the last index)."""
import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import place
from torch_op_parity import EXACT, compare, rng, run_both

F32 = (1e-6, 1e-6)
SPECIAL = (1e-5, 1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def _x(seed=0, shape=(3, 4), lo=-2.0, hi=2.0):
    return rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _i(seed=0, shape=(3, 4), lo=-9, hi=10):
    return rng(seed).randint(lo, hi, shape).astype(np.int32)


X, Y = _x(0), _x(1)
POS = _x(2, lo=0.1, hi=3.0)
UNIT = _x(3, lo=-0.9, hi=0.9)
BIG = _x(4, lo=1.1, hi=4.0)
I, J = _i(5), _i(6, lo=1, hi=7)
TIES = np.array([[1.0, 3.0, 3.0, 2.0, 3.0], [0.5, 0.5, -1.0, 0.5, 2.0]],
                np.float32)
EVEN = np.array([[4.0, 1.0, 3.0, 2.0], [7.0, -1.0, 5.0, 5.0]], np.float32)
NANS = np.array([[1.0, np.nan, np.inf], [-np.inf, 0.5, np.nan]],
                np.float32)

BINARY = [
    ("add", X, Y, F32), ("subtract", X, Y, F32), ("multiply", X, Y, F32),
    ("divide", X, POS, F32), ("floor_divide", I, J, EXACT),
    ("floor_divide", X, POS, EXACT), ("mod", I, J, EXACT),
    ("mod", X, POS, F32), ("remainder", -POS, POS[::-1].copy(), F32),
    ("floor_mod", I, -J, EXACT), ("pow", POS, Y, F32),
    ("maximum", X, Y, EXACT), ("minimum", X, Y, EXACT),
    ("fmax", NANS, NANS[:, ::-1].copy(), EXACT),
    ("fmin", NANS, NANS[:, ::-1].copy(), EXACT),
    ("atan2", X, Y, F32), ("hypot", X, Y, F32), ("logaddexp", X, Y, F32),
    ("heaviside", X, Y, EXACT), ("nextafter", X, Y, EXACT),
    ("copysign", X, Y, EXACT), ("gcd", I, J, EXACT), ("lcm", I, J, EXACT),
    ("add", X, 2.5, F32), ("multiply", I, 3, EXACT),
    ("kron", X[:2, :2].copy(), Y[:2, :3].copy(), F32),
    ("inner", X, Y, F32), ("outer", X[0].copy(), Y[1].copy(), F32),
    ("isclose", X, X + 1e-6, EXACT), ("allclose", X, X + 1e-3, EXACT),
    ("equal_all", I, I.copy(), EXACT), ("equal_all", I, J, EXACT),
]

UNARY = [
    ("exp", X, F32), ("expm1", X, F32), ("log", POS, F32), ("log2", POS, F32),
    ("log10", POS, F32), ("log1p", POS, F32), ("sqrt", POS, F32),
    ("rsqrt", POS, F32), ("square", X, F32), ("abs", X, EXACT),
    ("abs", I, EXACT), ("sign", X, EXACT), ("neg", X, EXACT),
    ("reciprocal", POS, F32), ("floor", X, EXACT), ("ceil", X, EXACT),
    ("round", np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.49], np.float32),
     EXACT), ("trunc", X, EXACT), ("frac", X, F32), ("sin", X, F32),
    ("cos", X, F32), ("tan", UNIT, F32), ("asin", UNIT, F32),
    ("acos", UNIT, F32), ("atan", X, F32), ("sinh", X, F32), ("cosh", X, F32),
    ("tanh", X, F32), ("asinh", X, F32), ("acosh", BIG, F32),
    ("atanh", UNIT, F32), ("erf", X, F32), ("erfinv", UNIT, SPECIAL),
    ("sigmoid", X, F32), ("digamma", POS, SPECIAL), ("lgamma", POS, SPECIAL),
    ("angle", X, EXACT), ("conj", X, EXACT), ("real", X, EXACT),
    ("imag", X, EXACT), ("deg2rad", X, F32), ("rad2deg", X, F32),
    ("isfinite", NANS, EXACT), ("isinf", NANS, EXACT), ("isnan", NANS, EXACT),
    ("nan_to_num", NANS, F32), ("stanh", X, F32),
]

REDUCTIONS = [
    ("sum", X, {}, F32), ("sum", X, {"axis": 1, "keepdim": True}, F32),
    ("sum", I, {"axis": [0, 1]}, EXACT), ("mean", X, {"axis": 0}, F32),
    ("max", X, {"axis": 1}, EXACT), ("min", X, {}, EXACT),
    ("prod", X, {"axis": 1}, F32), ("prod", X, {"axis": [0, 1]}, F32),
    ("prod", X, {"axis": 0, "keepdim": True}, F32),
    ("logsumexp", X, {"axis": 1}, F32), ("amax", X, {"axis": 0}, EXACT),
    ("amin", X, {"axis": [0, 1], "keepdim": True}, EXACT),
    ("all", X > 0, {"axis": 1}, EXACT), ("any", X > 1, {}, EXACT),
    ("var", X, {"axis": 1}, F32), ("std", X, {"unbiased": False}, F32),
    ("median", EVEN, {"axis": 1}, F32), ("median", EVEN, {}, F32),
    ("median", X[:, :3].copy(), {"axis": 1, "keepdim": True}, F32),
    ("quantile", X, {"q": 0.3, "axis": 1}, F32),
    ("quantile", X, {"q": np.array([0.25, 0.75]), "axis": 0}, F32),
    ("nanmean", NANS, {"axis": 1}, F32), ("nansum", NANS, {"axis": 0}, F32),
    ("count_nonzero", I, {"axis": 1}, EXACT),
    ("trace", X, {"offset": 1}, F32),
]

SCANS = [
    ("cumsum", X, {"axis": 1}, F32), ("cumsum", X, {}, F32),
    ("cumprod", X, {"dim": 0}, F32), ("cummax", TIES, {"axis": 1}, EXACT),
    ("cummin", TIES, {"axis": 1}, EXACT), ("cummax", TIES, {}, EXACT),
    ("logcumsumexp", X, {"axis": 1}, F32),
    ("diff", X, {"axis": 1}, F32), ("diff", X, {"n": 2, "axis": 0}, F32),
]


def _id(case):
    return case[0]


@pytest.mark.parametrize("name,x,y,tol", BINARY,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(BINARY)])
def test_binary_op_matches_reference(name, x, y, tol):
    got, want = run_both(name, [x, y])
    compare(got, want, tol, name)


@pytest.mark.parametrize("name,x,tol", UNARY,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(UNARY)])
def test_unary_op_matches_reference(name, x, tol):
    got, want = run_both(name, [x])
    compare(got, want, tol, name)


@pytest.mark.parametrize("name,x,kw,tol", REDUCTIONS + SCANS,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(REDUCTIONS + SCANS)])
def test_reduction_or_scan_matches_reference(name, x, kw, tol):
    got, want = run_both(name, [x], kw)
    compare(got, want, tol, name)


def test_median_of_an_even_count_is_the_mean_of_the_middle_pair():
    got, want = run_both("median", [np.array([4.0, 1.0, 3.0, 2.0],
                                             np.float32)])
    assert float(want) == 2.5 and float(got) == 2.5


def test_mod_is_floor_mod_for_negative_operands():
    a = np.array([-7, 7, -7, 7], np.int32)
    b = np.array([3, -3, -3, 3], np.int32)
    for name in ("mod", "remainder", "floor_mod"):
        got, want = run_both(name, [a, b])
        np.testing.assert_array_equal(want, [2, -2, -1, 1])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw", [
    ("scale", {"scale": 2.0, "bias": 1.0}),
    ("scale", {"scale": 2.0, "bias": 1.0, "bias_after_scale": False}),
    ("clip", {"min": -0.5, "max": 0.7}), ("clip", {"min": 0.0}),
    ("lerp", None), ("add_n", None), ("multiplex", None),
    ("increment", {"value": 2.0})])
def test_composite_op_matches_reference(name, kw):
    if name == "lerp":
        got, want = run_both(name, [X, Y, 0.3])
    elif name == "add_n":
        got, want = run_both(name, [[X, Y, POS]])
    elif name == "multiplex":
        got, want = run_both(name, [[X, Y], np.array([[1], [0], [1]],
                                                     np.int32)])
    else:
        got, want = run_both(name, [X.copy()], kw)
    compare(got, want, F32, name)


def test_tensor_operators_match_reference():
    import paddle_tpu as jp

    a, b = I, J
    for op in ("__floordiv__", "__mod__", "__add__", "__mul__", "__sub__",
               "__pow__"):
        want = np.asarray(getattr(jp.to_tensor(a), op)(jp.to_tensor(b))
                          ._value)
        got = getattr(pt.to_tensor(a), op)(pt.to_tensor(b)).numpy()
        compare(got, want, EXACT, op)
    want = np.asarray(abs(jp.to_tensor(X))._value)
    compare(abs(pt.to_tensor(X)).numpy(), want, EXACT, "abs")
