"""The port's linear algebra (``paddle_tpu_torch/ops/linalg.py``)
against ``paddle_tpu/ops/linalg.py`` on the CPU, each op one case on the
same seeded numpy inputs.

Tolerances: products, solves and norms of f32 [4, 4]-sized operands
within 1e-5 relative and absolute (sums of a few f32 products in
another order, and LAPACK's pivoting against XLA's); exact for counts
(``histogram``, ``bincount``, ``matrix_rank``).  The decompositions
(``qr``, ``svd``, ``eig``, ``eigh``, ``cholesky``) are compared by
reconstruction and by their invariants (orthogonality, ascending or
equal eigenvalue sets, singular values), not elementwise: the sign and
phase conventions of LAPACK and XLA differ.  ``weight_only_matmul`` is
held against the reference's plain dequant-matmul at the rule of the
port's CPU route (its plain version, ``QMM_ROUTE_STATS["ref"]``)."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import place
from torch_op_parity import EXACT, compare, rng, run_both, to_numpy, wrap

TOL = (1e-5, 1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


R = rng(11)
A = R.uniform(-1, 1, (4, 4)).astype(np.float32)
B = R.uniform(-1, 1, (4, 3)).astype(np.float32)
SPD = (A @ A.T + 4 * np.eye(4)).astype(np.float32)
TRI = np.triu(A) + 3 * np.eye(4, dtype=np.float32)
TALL = R.uniform(-1, 1, (6, 3)).astype(np.float32)
BATCH = R.uniform(-1, 1, (2, 3, 4)).astype(np.float32)
V3 = R.uniform(-1, 1, (2, 3)).astype(np.float32)
IDX = R.randint(0, 6, (10,)).astype(np.int32)

CASES = [
    ("matmul", [A, B], {}, TOL),
    ("matmul", [A, B], {"transpose_x": True}, TOL),
    ("matmul", [B, A], {"transpose_x": True, "transpose_y": True}, TOL),
    ("matmul", [BATCH, A], {}, TOL), ("mm", [A, B], {}, TOL),
    ("bmm", [BATCH, BATCH.transpose(0, 2, 1).copy()], {}, TOL),
    ("dot", [A, A[::-1].copy()], {}, TOL),
    ("matmul_with_flatten", [BATCH, B.T.reshape(4, 3).copy()],
     {"x_num_col_dims": 2}, TOL),
    ("norm", [A], {}, TOL), ("norm", [A], {"p": 1, "axis": 1}, TOL),
    ("norm", [A], {"p": float("inf"), "axis": 0}, TOL),
    ("norm", [A], {"p": 0, "axis": 1, "keepdim": True}, TOL),
    ("dist", [A, SPD], {"p": 3}, TOL), ("cross", [V3, V3[::-1].copy()], {},
                                        TOL),
    ("cholesky_solve", [B, np.linalg.cholesky(SPD).astype(np.float32)], {},
     TOL),
    ("triangular_solve", [TRI, B], {}, TOL),
    ("triangular_solve", [TRI, B], {"transpose": True}, TOL),
    ("triangular_solve", [TRI.T.copy(), B], {"upper": False,
                                             "unitriangular": True}, TOL),
    ("inverse", [SPD], {}, TOL), ("pinv", [TALL], {}, TOL),
    ("solve", [SPD, B], {}, TOL), ("det", [SPD], {}, (1e-5, 1e-4)),
    ("slogdet", [A], {}, TOL), ("eigvalsh", [SPD], {}, TOL),
    ("matrix_rank", [np.outer(A[0], A[1]).astype(np.float32)], {}, EXACT),
    ("matrix_rank", [A], {"tol": 0.5}, EXACT),
    ("matrix_power", [A], {"n": 3}, TOL),
    ("multi_dot", [[A, SPD, B]], {}, (1e-5, 1e-4)),
    ("histogram", [A], {"bins": 5}, EXACT),
    ("histogram", [A], {"bins": 4, "min": -0.5, "max": 0.5}, EXACT),
    ("bincount", [IDX], {}, EXACT),
    ("bincount", [IDX], {"weights": None, "minlength": 9}, EXACT),
    ("corrcoef", [B.T.copy()], {}, TOL), ("cov", [B], {}, TOL),
    ("cov", [B], {"rowvar": False, "ddof": False}, TOL),
]


@pytest.mark.parametrize("name,args,kw,tol", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_linalg_op_matches_reference(name, args, kw, tol):
    got, want = run_both(name, args, kw)
    compare(got, want, tol, name)


def test_weighted_bincount_and_einsum_match_reference():
    w = rng(3).uniform(0, 1, IDX.shape).astype(np.float32)
    want = to_numpy(jp.bincount(jp.to_tensor(IDX), jp.to_tensor(w)))
    got = to_numpy(pt.bincount(pt.to_tensor(IDX), pt.to_tensor(w)))
    compare(got, want, TOL, "bincount weights")
    want = to_numpy(jp.einsum("bij,jk->bik", jp.to_tensor(BATCH),
                              jp.to_tensor(B)))
    got = to_numpy(pt.einsum("bij,jk->bik", pt.to_tensor(BATCH),
                             pt.to_tensor(B)))
    compare(got, want, TOL, "einsum")


def test_lstsq_matches_numpy_and_reference():
    y = rng(5).uniform(-1, 1, (6, 2)).astype(np.float32)
    got, want = run_both("lstsq", [TALL, y])
    for g, w, what in zip(got, want, ("solution", "residuals", "rank",
                                      "singular values")):
        if what == "rank":
            assert int(g) == int(w)
        else:
            compare(g, w, (1e-4, 1e-5), what)


def _orthonormal(q, n):
    np.testing.assert_allclose(q.T @ q, np.eye(n), atol=1e-5)


@pytest.mark.parametrize("mode", ["reduced", "complete"])
def test_qr_reconstructs_and_matches_up_to_signs(mode):
    (gq, gr), (wq, wr) = run_both("qr", [TALL], {"mode": mode})
    assert gq.shape == wq.shape and gr.shape == wr.shape
    k = gr.shape[0]
    np.testing.assert_allclose(gq[:, :k] @ gr, TALL, atol=1e-5)
    _orthonormal(gq, gq.shape[1])
    np.testing.assert_allclose(np.abs(np.diag(gr)), np.abs(np.diag(wr)),
                               rtol=1e-5)
    assert np.allclose(np.triu(gr), gr)


def test_svd_reconstructs_with_the_reference_singular_values():
    (gu, gs, gvh), (wu, ws, wvh) = run_both("svd", [TALL])
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((gu * gs) @ gvh, TALL, atol=1e-5)
    _orthonormal(gu, 3)
    # the singular vectors agree up to one sign per pair
    signs = np.sign(np.sum(gu * wu, axis=0))
    np.testing.assert_allclose(gu * signs, wu, atol=1e-4)


def test_eigh_and_eig_invariants():
    (gw, gv), (ww, wv) = run_both("eigh", [SPD])
    np.testing.assert_allclose(gw, ww, rtol=1e-5)
    np.testing.assert_allclose(SPD @ gv, gv * gw, atol=1e-4)
    _orthonormal(gv, 4)
    (gw, gv), (ww, wv) = run_both("eig", [A])
    key = lambda z: (np.round(z.real, 4), np.round(z.imag, 4))  # noqa: E731
    np.testing.assert_allclose(sorted(gw, key=key), sorted(ww, key=key),
                               atol=1e-4)
    np.testing.assert_allclose(A @ gv, gv * gw, atol=1e-4)
    got, want = run_both("eigvals", [A])
    np.testing.assert_allclose(sorted(got, key=key), sorted(want, key=key),
                               atol=1e-4)


@pytest.mark.parametrize("upper", [False, True])
def test_cholesky_reconstructs(upper):
    got, want = run_both("cholesky", [SPD], {"upper": upper})
    compare(got, want, TOL, "cholesky")
    rec = got.T @ got if upper else got @ got.T
    np.testing.assert_allclose(rec, SPD, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_only_matmul_matches_reference(dtype):
    from paddle_tpu_torch.ops.quantized_matmul import QMM_ROUTE_STATS

    r = rng(21)
    x = r.uniform(-1, 1, (2, 5, 32)).astype(np.float32)
    wq = r.randint(-127, 128, (32, 48)).astype(np.int8)
    ws = r.uniform(0.001, 0.02, (48,)).astype(np.float32)
    jx = jp.to_tensor(x).astype(dtype)
    want = to_numpy(jp.weight_only_matmul(jx, jp.to_tensor(wq),
                                          jp.to_tensor(ws)))
    before = QMM_ROUTE_STATS["ref"]
    tx = pt.to_tensor(x).astype(dtype)
    got = pt.weight_only_matmul(tx, wrap(pt, wq), wrap(pt, ws))
    assert QMM_ROUTE_STATS["ref"] == before + 1
    assert got.shape == [2, 5, 48] and got.dtype == tx.dtype
    tol = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 1e-2)
    compare(to_numpy(got), want, tol, "weight_only_matmul")
    # the method form reaches the same op
    compare(to_numpy(tx.weight_only_matmul(wrap(pt, wq), wrap(pt, ws))),
            want, tol, "Tensor.weight_only_matmul")
