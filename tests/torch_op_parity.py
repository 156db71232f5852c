"""Shared helpers of the op parity tests (``tests/test_torch_ops_*.py``):
the same numpy inputs through a ``paddle_tpu`` function and its
``paddle_tpu_torch`` twin (``set_device("cpu")``), the outputs compared
value for value.

Dtypes differ by design where JAX runs without 64-bit types: the JAX
package gives int32 where the port keeps paddle's int64 (indices,
integer sums, ``arange``), and float32 where the port keeps float64.
:func:`compare` allows exactly those pairs and no other."""
import numpy as np
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt

EXACT = "exact"
# dtype pairs (port, JAX package) that differ by design
DESIGN_DTYPES = {(np.dtype("int64"), np.dtype("int32")),
                 (np.dtype("float64"), np.dtype("float32")),
                 (np.dtype("complex128"), np.dtype("complex64"))}


def rng(seed=0):
    return np.random.RandomState(seed)


def wrap(pkg, a):
    """numpy arrays (alone or in a list) as ``pkg``'s Tensors."""
    if isinstance(a, np.ndarray):
        return pkg.to_tensor(a)
    if isinstance(a, (list, tuple)) and a and all(
            isinstance(x, np.ndarray) for x in a):
        return [pkg.to_tensor(x) for x in a]
    return a


def to_numpy(out):
    if isinstance(out, (tuple, list)):
        return [to_numpy(o) for o in out]
    v = getattr(out, "_value", out)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def compare(got, want, tol, what=""):
    """``got`` (the port's) against ``want`` (the JAX package's): the
    same structure and shapes, dtypes equal or a pair of DESIGN_DTYPES,
    values exactly equal (``tol == EXACT``) or within ``tol = (rtol,
    atol)``; NaNs must match."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            compare(g, w, tol, f"{what}[{i}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} vs {w.shape}"
    assert g.dtype == w.dtype or (g.dtype, w.dtype) in DESIGN_DTYPES, \
        f"{what}: dtype {g.dtype} vs {w.dtype}"
    if tol == EXACT:
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        rtol, atol = tol
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=what)


def run_both(name, args, kwargs=None, mod_j=None, mod_t=None):
    """``name(*args, **kwargs)`` in both packages (their top-level
    namespace unless modules are given); numpy outputs (port, JAX)."""
    kwargs = kwargs or {}
    fj = getattr(mod_j or jp, name)
    ft = getattr(mod_t or pt, name)
    want = to_numpy(fj(*[wrap(jp, a) for a in args], **kwargs))
    got = to_numpy(ft(*[wrap(pt, a) for a in args], **kwargs))
    return got, want
