"""Linear algebra ops — twin of ``paddle_tpu/ops/linalg.py``.

``matmul`` dispatches as "matmul_v2" (AMP casts it as the reference's
lists say); f32 precision is torch's (``allow_tf32``).
``weight_only_matmul`` is ``x @ (w_q * w_scale)`` through the port's
``ops/quantized_matmul.py``: on a CUDA tensor it launches the hand-
written kernel #4 (``csrc/quantized_matmul.cu``), on a CPU tensor its
plain version.  The reference's host-side numpy ops (``lstsq``, ``eig``,
``eigvals``, ``histogram``, ``bincount`` with weights) run on the
device here; their shapes that depend on the data (``lstsq``'s
residuals) are read back.  Decompositions differ from the reference's
by the sign and order conventions of the LAPACK / cuSOLVER routines."""
from __future__ import annotations

import math

import torch

from ..framework.errors import InvalidArgumentError
from ._helpers import norm_axis, to_tensor_like
from .dispatch import apply

__all__ = ["matmul", "mm", "weight_only_matmul", "bmm", "dot",
           "matmul_with_flatten", "norm", "dist", "cross", "cholesky",
           "cholesky_solve", "triangular_solve", "inverse", "pinv", "solve",
           "lstsq", "det", "slogdet", "svd", "qr", "eig", "eigh", "eigvals",
           "eigvalsh", "matrix_rank", "matrix_power", "multi_dot",
           "histogram", "bincount", "corrcoef", "cov", "einsum"]


def _pair(x, y):
    x = to_tensor_like(x)
    return x, to_tensor_like(y, x)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = _pair(x, y)

    def f(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply("matmul_v2", f, x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def weight_only_matmul(x, w_q, w_scale, name=None):
    """Weight-only int8 matmul ``x @ (w_q * w_scale[None, :])``: x
    ``[..., K]`` float32 or bfloat16, ``w_q [K, N]`` int8, ``w_scale
    [N]`` float32 (one dequant scale per output channel); the result has
    x's dtype.  Routes through ``ops/quantized_matmul.py``: the CUDA
    kernel on the card (``QMM_ROUTE_STATS["cuda"]``), the plain version
    on the CPU."""
    from .quantized_matmul import quantized_matmul as _core

    x = to_tensor_like(x)
    return apply("weight_only_matmul", _core, x, to_tensor_like(w_q, x),
                 to_tensor_like(w_scale, x))


def bmm(x, y, name=None):
    return matmul(x, y)


def dot(x, y, name=None):
    x, y = _pair(x, y)
    return apply("dot", lambda a, b: torch.sum(a * b, dim=-1), x, y)


def matmul_with_flatten(x, y, x_num_col_dims=1, name=None):
    """The reference's ``mul`` op: x flattened to 2-D at
    ``x_num_col_dims``, then the product."""
    x, y = _pair(x, y)

    def f(a, b):
        lead = list(a.shape[:x_num_col_dims])
        a2 = a.reshape(math.prod(lead), -1)
        return torch.matmul(a2, b).reshape(lead + [b.shape[-1]])

    return apply("mul", f, x, y)


def _p_norm(v, p, ax, keepdim):
    dims = tuple(range(v.dim())) if ax is None else (
        (ax,) if isinstance(ax, int) else ax)
    if p == "fro":
        return torch.sqrt(torch.sum(v * v, dim=dims, keepdim=keepdim))
    if p == float("inf"):
        return torch.amax(torch.abs(v), dim=dims, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(v), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((v != 0).to(v.dtype), dim=dims, keepdim=keepdim)
    return torch.sum(torch.abs(v) ** p, dim=dims,
                     keepdim=keepdim) ** (1.0 / p)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    x = to_tensor_like(x)
    ax = norm_axis(axis)
    return apply("p_norm", lambda v: _p_norm(v, p, ax, keepdim), x)


def dist(x, y, p=2, name=None):
    x, y = _pair(x, y)
    return apply("dist", lambda a, b: _p_norm(a - b, p, None, False), x, y)


def cross(x, y, axis=9, name=None):
    x, y = _pair(x, y)
    ax = axis
    if ax == 9:  # paddle's default: the first axis of length 3
        ax = next(i for i, d in enumerate(x.shape) if d == 3)
    return apply("cross", lambda a, b: torch.linalg.cross(a, b, dim=ax),
                 x, y)


def cholesky(x, upper=False, name=None):
    return apply("cholesky", lambda v: torch.linalg.cholesky(v, upper=upper),
                 to_tensor_like(x))


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A z = x`` for ``A = L L^T`` given its factor ``y``."""
    x, y = _pair(x, y)
    return apply("cholesky_solve", lambda b, c: torch.cholesky_solve(
        b, c, upper=upper), x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solve ``x z = y`` (``x^T z = y`` with ``transpose``) for a
    triangular ``x``."""
    x, y = _pair(x, y)

    def f(a, b):
        up = upper
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return apply("triangular_solve", f, x, y)


def inverse(x, name=None):
    return apply("inverse", torch.linalg.inv, to_tensor_like(x))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply("pinv", lambda v: torch.linalg.pinv(
        v, rtol=rcond, hermitian=hermitian), to_tensor_like(x))


def solve(x, y, name=None):
    x, y = _pair(x, y)
    return apply("solve", torch.linalg.solve, x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular_values)`` as
    ``np.linalg.lstsq``: the minimum-norm solution through the SVD,
    singular values below ``rcond`` (default: machine epsilon times the
    larger dimension) times the largest treated as zero; residuals (the
    squared 2-norms of each column's error) only for a full-rank tall
    ``x``, else empty."""
    x, y = _pair(x, y)

    def f(a, b):
        m, n = a.shape[-2], a.shape[-1]
        rc = (torch.finfo(a.dtype).eps * max(m, n) if rcond is None
              else rcond)
        sv = torch.linalg.svdvals(a)
        rank = torch.sum(sv > rc * sv.max())
        sol = torch.linalg.pinv(a, rtol=rc) @ b
        if m > n and int(rank) == n:
            err = a @ sol - b
            res = torch.sum(err * err, dim=0)
        else:
            res = torch.zeros((0,), dtype=a.dtype, device=a.device)
        return sol, res, rank, sv

    return apply("lstsq", f, x, y)


def det(x, name=None):
    return apply("determinant", torch.linalg.det, to_tensor_like(x))


def slogdet(x, name=None):
    return apply("slogdet", lambda v: tuple(torch.linalg.slogdet(v)),
                 to_tensor_like(x))


def svd(x, full_matrices=False, name=None):
    """``(u, s, vh)`` with ``x = u @ diag(s) @ vh``."""
    return apply("svd", lambda v: tuple(torch.linalg.svd(
        v, full_matrices=full_matrices)), to_tensor_like(x))


def qr(x, mode="reduced", name=None):
    def f(v):
        q, r = torch.linalg.qr(v, mode=mode)
        return r if mode == "r" else (q, r)

    return apply("qr", f, to_tensor_like(x))


def eig(x, name=None):
    """Complex eigenvalues and eigenvectors of a general matrix."""
    return apply("eig", lambda v: tuple(torch.linalg.eig(v)),
                 to_tensor_like(x))


def eigh(x, UPLO="L", name=None):
    """Eigen-decomposition of the symmetrized input ``(x + x^H) / 2``,
    as the reference's ``symmetrize_input=True``; ascending values."""
    def f(v):
        sym = (v + v.transpose(-1, -2).conj()) / 2
        return tuple(torch.linalg.eigh(sym, UPLO=UPLO))

    return apply("eigh", f, to_tensor_like(x))


def eigvals(x, name=None):
    return apply("eigvals", torch.linalg.eigvals, to_tensor_like(x))


def eigvalsh(x, UPLO="L", name=None):
    return apply("eigvalsh", torch.linalg.eigvalsh, to_tensor_like(x))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    def f(v):
        if tol is None:
            return torch.linalg.matrix_rank(v, hermitian=hermitian)
        return torch.linalg.matrix_rank(v, atol=tol, rtol=0.0,
                                        hermitian=hermitian)

    return apply("matrix_rank", f, to_tensor_like(x))


def matrix_power(x, n, name=None):
    return apply("matrix_power", lambda v: torch.linalg.matrix_power(v, n),
                 to_tensor_like(x))


def multi_dot(tensors, name=None):
    ts = [to_tensor_like(t) for t in tensors]
    return apply("multi_dot", lambda *vs: torch.linalg.multi_dot(vs), *ts)


def histogram(input, bins=100, min=0, max=0, name=None):
    """int64 counts of ``bins`` equal bins over ``[min, max]`` (the
    data's range when both are 0), the last bin closed."""
    return apply("histogram", lambda v: torch.histc(
        v.float(), bins=bins, min=min, max=max).to(torch.int64),
        to_tensor_like(input))


def bincount(x, weights=None, minlength=0, name=None):
    x = to_tensor_like(x)
    w = to_tensor_like(weights, x) if weights is not None else None
    return apply("bincount", lambda v, wv: torch.bincount(
        v.long(), weights=wv, minlength=minlength), x, w)


def _cov(v, rowvar, ddof):
    """``jnp.cov``'s arithmetic (``torch.cov`` reads its weights' sum
    back to the host): the variables on the rows, centred, ``X X^H / (N -
    ddof)``."""
    v = v if rowvar else v.transpose(-1, -2)
    v = v.reshape(-1, v.shape[-1]) if v.dim() > 1 else v[None]
    if not (v.is_floating_point() or v.is_complex()):
        v = v.float()
    c = v - v.mean(dim=1, keepdim=True)
    return (c @ c.transpose(-1, -2).conj() / (v.shape[1] - ddof)).squeeze()


def corrcoef(x, rowvar=True, name=None):
    def f(v):
        c = _cov(v, rowvar, 1)
        if c.dim() == 0:
            return c / c
        d = torch.sqrt(torch.diagonal(c).real)
        return torch.clamp(c / d[:, None] / d[None, :], -1.0, 1.0)

    return apply("corrcoef", f, to_tensor_like(x))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    if fweights is not None or aweights is not None:
        raise InvalidArgumentError(
            "cov(fweights=, aweights=) is not ported (the reference ignores "
            "them; ROADMAP queue 1 item 8)")
    return apply("cov", lambda v: _cov(v, rowvar, 1 if ddof else 0),
                 to_tensor_like(x))


def einsum(equation, *operands):
    ts = [to_tensor_like(t) for t in operands]
    return apply("einsum", lambda *vs: torch.einsum(equation, *vs), *ts)
