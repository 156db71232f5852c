"""The port's comparison, logical, search and sort ops
(``paddle_tpu_torch/ops/{logic,search}.py``) against
``paddle_tpu/ops/{logic,search}.py`` on the CPU, each op one case on
the same seeded numpy inputs.  All exact: they compare, select and
order values.  Ties are where parity is likely to break, so the inputs
hold them: ``argsort(descending=True)`` keeps tied entries in their
order (a stable sort of ``-x``), ``topk`` and ``kthvalue`` give a tie
the lower index (``jax.lax.top_k``), ``mode`` takes the smallest of the
most frequent values and its last index (numpy on the host in the
reference, the device here).  Indices are int64 in the port, int32 in
the reference (JAX without 64-bit types)."""
import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import place
from torch_op_parity import EXACT, compare, rng, run_both, to_numpy


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


R = rng(13)
X = R.uniform(-2, 2, (3, 5)).astype(np.float32)
Y = R.uniform(-2, 2, (3, 5)).astype(np.float32)
I = R.randint(-4, 5, (3, 5)).astype(np.int32)
J = R.randint(-4, 5, (3, 5)).astype(np.int32)
B1, B2 = X > 0, Y > 0
TIES = np.array([[3.0, 1.0, 3.0, 2.0, 3.0, 1.0],
                 [0.0, 5.0, 5.0, -1.0, 0.0, 5.0]], np.float32)
MODES = np.array([[1, 2, 2, 3, 3, 1], [4, 4, 4, 0, 0, 0],
                  [7, 7, 1, 2, 2, 9]], np.int32)
SORTED = np.sort(R.uniform(-2, 2, (8,))).astype(np.float32)
SORTED2 = np.sort(R.uniform(-2, 2, (3, 6)), axis=1).astype(np.float32)

LOGIC = [
    ("equal", [I, J]), ("not_equal", [I, J]), ("greater_than", [X, Y]),
    ("greater_equal", [I, J]), ("less_than", [X, Y]), ("less_equal", [I, J]),
    ("logical_and", [B1, B2]), ("logical_or", [B1, B2]),
    ("logical_xor", [B1, B2]), ("bitwise_and", [I, J]),
    ("bitwise_or", [I, J]), ("bitwise_xor", [I, J]), ("logical_not", [B1]),
    ("bitwise_not", [I]), ("is_empty", [X]), ("is_empty", [X[:0]]),
    ("where", [B1, X, Y]), ("equal", [I, 2]), ("where", [B1]),
]

SEARCH = [
    ("argmax", [X], {}), ("argmax", [X], {"axis": 1, "keepdim": True}),
    ("argmin", [TIES], {"axis": 1}), ("argmax", [TIES], {"axis": 1}),
    ("argsort", [TIES], {}), ("argsort", [TIES], {"descending": True}),
    ("argsort", [X], {"axis": 0, "descending": True}),
    ("sort", [TIES], {"descending": True}), ("sort", [X], {"axis": 0}),
    ("topk", [TIES], {"k": 3}), ("topk", [TIES], {"k": 2, "largest": False}),
    ("topk", [X], {"k": 2, "axis": 0}), ("kthvalue", [TIES], {"k": 2}),
    ("kthvalue", [X], {"k": 2, "axis": 0, "keepdim": True}),
    ("mode", [MODES], {}), ("mode", [MODES.T.copy()], {"axis": 0}),
    ("mode", [TIES], {"keepdim": True}), ("nonzero", [I], {}),
    ("nonzero", [I], {"as_tuple": True}), ("masked_select", [X, B1], {}),
    ("masked_fill", [X, B1], {"value": -7.0}),
    ("searchsorted", [SORTED, X], {}),
    ("searchsorted", [SORTED, X], {"right": True, "out_int32": True}),
    ("searchsorted", [SORTED2, X[:, :4].copy()], {}),
    ("bucketize", [X, SORTED], {}),
]


@pytest.mark.parametrize("name,args", LOGIC,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LOGIC)])
def test_logic_op_matches_reference(name, args):
    got, want = run_both(name, args)
    compare(got, want, EXACT, name)


@pytest.mark.parametrize("name,args,kw", SEARCH,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SEARCH)])
def test_search_op_matches_reference(name, args, kw):
    got, want = run_both(name, args, kw)
    compare(got, want, EXACT, name)


def test_topk_ties_go_to_the_lower_index():
    (vals, idx), _ = run_both("topk", [TIES], {"k": 3})
    np.testing.assert_array_equal(idx[0], [0, 2, 4])
    np.testing.assert_array_equal(idx[1], [1, 2, 5])


def test_index_put_matches_reference():
    import paddle_tpu as jp

    rows = np.array([0, 2], np.int32)
    cols = np.array([1, 4], np.int32)
    val = np.array([9.0, -9.0], np.float32)
    for acc in (False, True):
        want = to_numpy(jp.index_put(
            jp.to_tensor(X), (jp.to_tensor(rows), jp.to_tensor(cols)),
            jp.to_tensor(val), accumulate=acc))
        got = to_numpy(pt.index_put(
            pt.to_tensor(X), (pt.to_tensor(rows), pt.to_tensor(cols)),
            pt.to_tensor(val), accumulate=acc))
        compare(got, want, EXACT, f"index_put accumulate={acc}")


def test_cond_runs_one_branch():
    import paddle_tpu as jp

    for pred in (True, False):
        want = jp.cond(jp.to_tensor(pred), lambda: 1, lambda: 2)
        assert pt.cond(pt.to_tensor(pred), lambda: 1, lambda: 2) == want
