"""The port's shape, gather / scatter and creation ops
(``paddle_tpu_torch/ops/{manipulation,creation}.py``) against
``paddle_tpu/ops/{manipulation,creation}.py`` on the CPU, each op one
case on the same seeded numpy inputs.  Every case is exact: these ops
move, select or write values without arithmetic; ``tensordot``,
``linspace`` and ``logspace`` compute, within 1e-6 relative and
absolute (f32 sums in another order).  ``unique`` and
``unique_consecutive`` run on the device in the port and through numpy
on the host in the reference: same values, order, first-occurrence
indices, inverse map and counts.  Integer outputs are int64 in the port
and int32 in the reference (JAX without 64-bit types), as
``torch_op_parity.DESIGN_DTYPES`` allows."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import place
from torch_op_parity import EXACT, compare, rng, run_both, to_numpy

F32 = (1e-6, 1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


R = rng(7)
X = R.uniform(-2, 2, (2, 3, 4)).astype(np.float32)
M = R.uniform(-2, 2, (3, 4)).astype(np.float32)
I3 = np.array([2, 0, 1], np.int32)
ROWS = np.array([[0, 2], [1, 1], [2, 0]], np.int32)
ND = np.array([[0, 1], [2, 3], [1, 0]], np.int32)
U = np.array([3, 1, 3, 2, 1, 1, 5, 2], np.int32)
U2 = np.array([[1, 2], [1, 2], [0, 1], [1, 2], [0, 1]], np.int32)
RUNS = np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int32)

CASES = [
    ("reshape", [X], {"shape": [4, 6]}), ("reshape", [X], {"shape": [-1, 4]}),
    ("transpose", [X], {"perm": [2, 0, 1]}), ("t", [M], {}),
    ("moveaxis", [X], {"source": 0, "destination": 2}),
    ("swapaxes", [X], {"axis1": 0, "axis2": 2}),
    ("concat", [[M, M * 2]], {"axis": 1}), ("stack", [[M, M]], {"axis": 1}),
    ("unstack", [X], {"axis": 1}), ("split", [X], {"num_or_sections": 2,
                                                   "axis": 2}),
    ("split", [X], {"num_or_sections": [1, -1], "axis": 1}),
    ("chunk", [X], {"chunks": 2, "axis": 0}),
    ("squeeze", [X[:1]], {"axis": 0}), ("unsqueeze", [M], {"axis": [0, 2]}),
    ("flatten", [X], {"start_axis": 1}),
    ("gather", [M], {"index": None, "axis": 1}),
    ("gather_nd", [M, ND], {}),
    ("take_along_axis", [M, ROWS], {"axis": 1}),
    ("put_along_axis", [M, ROWS, np.float32(9.0)], {"axis": 1}),
    ("put_along_axis", [M, ROWS, M[:, :2].copy()], {"axis": 1,
                                                    "reduce": "add"}),
    ("put_along_axis", [M, ROWS, M[:, :2].copy()], {"axis": 1,
                                                    "reduce": "multiply"}),
    ("scatter", [M, I3, M[::-1].copy()], {}),
    ("scatter", [M, np.array([0, 2, 0], np.int32), M * 3], {
        "overwrite": False}),
    ("scatter_nd_add", [M, ND, np.ones(3, np.float32)], {}),
    ("scatter_nd", [ND, np.arange(3, dtype=np.float32)], {"shape": [3, 4]}),
    ("index_select", [X, I3[:2].copy()], {"axis": 2}),
    ("index_sample", [M, ROWS], {}),
    ("take", [M, np.array([[0, 5], [11, 3]], np.int32)], {}),
    ("take", [M, np.array([13, -15], np.int32)], {"mode": "wrap"}),
    ("take", [M, np.array([13, 4], np.int32)], {"mode": "clip"}),
    ("expand", [M[:1]], {"shape": [2, 3, 4]}),
    ("expand", [M[:1]], {"shape": [3, -1]}), ("expand_as", [M[:1], M], {}),
    ("broadcast_to", [M[:, :1]], {"shape": [3, 4]}),
    ("broadcast_tensors", [[M[:1], M[:, :1]]], {}),
    ("tile", [M], {"repeat_times": [2, 1]}), ("tile", [M], {
        "repeat_times": [2, 1, 2]}),
    ("roll", [M], {"shifts": 2, "axis": 1}), ("roll", [M], {"shifts": 3}),
    ("flip", [X], {"axis": [0, 2]}), ("rot90", [M], {"k": 1}),
    ("rot90", [X], {"k": -1, "axes": [1, 2]}),
    ("slice", [X], {"axes": [1, 2], "starts": [1, -3], "ends": [3, 100]}),
    ("strided_slice", [X], {"axes": [2], "starts": [0], "ends": [4],
                            "strides": [2]}),
    ("strided_slice", [X], {"axes": [1, 2], "starts": [2, 3],
                            "ends": [-4, 0], "strides": [-1, -2]}),
    ("pad", [M], {"pad": [1, 0, 0, 2]}),
    ("pad", [X[None]], {"pad": [1, 2, 0, 1], "mode": "reflect"}),
    ("pad", [X[None]], {"pad": [1, 1, 2, 0], "mode": "replicate"}),
    ("pad", [X[None]], {"pad": [1, 1], "mode": "circular"}),
    ("pad", [X[None]], {"pad": [1, 0, 0, 1], "value": 2.0,
                        "data_format": "NHWC"}),
    ("repeat_interleave", [M], {"repeats": 2, "axis": 1}),
    ("repeat_interleave", [M], {"repeats": 2}), ("unbind", [M], {"axis": 1}),
    ("unique", [U], {}),
    ("unique", [U], {"return_index": True, "return_inverse": True,
                     "return_counts": True}),
    ("unique", [U2], {"axis": 0, "return_index": True,
                      "return_inverse": True, "return_counts": True}),
    ("unique_consecutive", [RUNS], {"return_inverse": True,
                                    "return_counts": True}),
    ("unique_consecutive", [U2], {"axis": 0, "return_counts": True}),
    ("as_real", [None], {}), ("crop", [X], {"shape": [1, 2, 2],
                                            "offsets": [1, 0, 2]}),
    ("shard_index", [np.array([[1], [6], [12], [19]], np.int32)], {
        "index_num": 20, "nshards": 2, "shard_id": 1}),
    ("tensordot", [X, M], {"axes": [[1, 2], [0, 1]]}),
    ("tensordot", [M, M.T.copy()], {"axes": 1}),
    ("reshape_", [M.copy()], {"shape": [4, 3]}),
    ("squeeze_", [X[:1].copy()], {"axis": 0}),
    ("unsqueeze_", [M.copy()], {"axis": 1}),
]


def _args(name, args, kw):
    kw = dict(kw)
    if name == "gather":
        kw["index"] = None
        return [args[0], I3], {"axis": 1}
    if name == "as_real":
        return [None], kw
    return args, kw


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_manipulation_op_matches_reference(name, args, kw):
    if name == "as_real":
        z = (M + 1j * M[::-1]).astype(np.complex64)
        want = to_numpy(jp.as_real(jp.to_tensor(z)))
        got = to_numpy(pt.as_real(pt.to_tensor(z)))
        compare(got, want, EXACT, name)
        back = to_numpy(pt.as_complex(pt.to_tensor(got)))
        compare(back, z, EXACT, "as_complex")
        return
    args, kw = _args(name, args, kw)
    got, want = run_both(name, args, kw)
    compare(got, want, F32 if name == "tensordot" else EXACT, name)


def test_take_wraps_a_negative_index_in_raise_mode():
    """The port wraps ``-size <= i < 0`` (paddle's rule); the reference
    checks the same range, then clips the index to 0 (ROADMAP §3)."""
    got = to_numpy(pt.take(pt.to_tensor(M), pt.to_tensor(
        np.array([-1, -12], np.int32))))
    np.testing.assert_array_equal(got, [M.reshape(-1)[-1], M[0, 0]])
    want = to_numpy(jp.take(jp.to_tensor(M), jp.to_tensor(
        np.array([-1], np.int32))))
    np.testing.assert_array_equal(want, [M[0, 0]])
    with pytest.raises(IndexError):
        pt.take(pt.to_tensor(M), pt.to_tensor(np.array([12], np.int32)))


CREATION = [
    ("zeros", [[2, 3]], {}), ("ones", [[2, 3]], {"dtype": "int32"}),
    ("full", [[2, 2], 1.5], {}), ("full", [[3], 7], {"dtype": "int64"}),
    ("empty", [[2, 1]], {}), ("arange", [5], {}), ("arange", [1, 7, 2], {}),
    ("arange", [0.0, 1.0, 0.25], {}), ("eye", [3], {}),
    ("eye", [2, 4], {"dtype": "int32"}), ("linspace", [0.0, 1.0, 5], {}),
    ("logspace", [0.0, 2.0, 3], {}), ("diag", [M[0].copy()], {"offset": 1}),
    ("diag", [M[0].copy()], {"padding_value": 9.0}), ("diag", [M], {}),
    ("diag", [M], {"offset": -1}), ("diagflat", [M[:2, :2].copy()], {}),
    ("tril", [M], {"diagonal": 1}), ("triu", [M], {"diagonal": -1}),
    ("zeros_like", [M], {}), ("ones_like", [M], {"dtype": "int32"}),
    ("full_like", [M], {"fill_value": 3.0}), ("empty_like", [M], {}),
    ("assign", [M], {}), ("clone", [M], {}), ("numel", [X], {}),
    ("meshgrid", [M[0].copy(), M[1, :3].copy()], {}),
]


@pytest.mark.parametrize("name,args,kw", CREATION,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CREATION)])
def test_creation_op_matches_reference(name, args, kw):
    got, want = run_both(name, args, kw)
    tol = F32 if name in ("linspace", "logspace") else EXACT
    compare(got, want, tol, name)


def test_creation_honours_the_default_dtype():
    prev = pt.get_default_dtype()
    pt.set_default_dtype("float64")
    try:
        assert pt.zeros([2]).dtype == pt.float64
        assert pt.full([2], 1).dtype == pt.float64
        assert pt.arange(0.0, 1.0, 0.5).dtype == pt.float64
        assert pt.randn([2]).dtype == pt.float64
        assert pt.rand([2]).dtype == pt.float64
        assert pt.arange(3).dtype == pt.int64
    finally:
        pt.set_default_dtype(prev)
    assert pt.zeros([2]).dtype == pt.float32
    with pytest.raises(ValueError):
        pt.set_default_dtype("int32")
