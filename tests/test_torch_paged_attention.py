"""paddle_tpu_torch ragged paged attention vs the JAX package.

The same numpy inputs (seeded) go through the port's routing entry on
CPU tensors (its plain PyTorch version) and through paddle_tpu's
``ragged_paged_attention_xla`` and its Pallas kernel in interpret mode;
``paged_attention_ref`` is held against ``paged_attention_xla``.  The
CUDA kernel itself is compared with the plain version in
``tests/test_torch_cuda.py``, which imports no JAX so that it also runs
on a machine with a card and no JAX.

Tolerance: 2e-5 absolute/relative in f32.  Both sides compute the same
exact softmax; they differ only in summation order over at most
M * P = 24 positions and D = 16 products (f32 eps 1.2e-7).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_ops.paged_attention import (
    paged_attention_xla, ragged_paged_attention_kernel,
    ragged_paged_attention_xla)
from paddle_tpu_torch.ops import paged_attention as pa

P, H, D, M = 4, 2, 16, 6
TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, Qb):
    """G=4 lanes over a 20-page pool (page 0 = trash, random content):
    lane 0 is empty, lane 1 ends mid-page, lane 2 fills its table, lane 3
    has extra real pages PAST its horizon (must be ignored); rows are a
    prefill staircase with padded (row_len 0) rows and rows shorter than
    their lane."""
    rng = np.random.RandomState(seed)
    G, N = 4, 20
    q = rng.randn(G, Qb, H, D).astype(np.float32)
    kp = rng.randn(N, P, H, D).astype(np.float32)
    vp = rng.randn(N, P, H, D).astype(np.float32)
    perm = rng.permutation(np.arange(1, N))
    pt = np.zeros((G, M), np.int32)
    pt[1, :2] = perm[0:2]
    pt[2, :M] = perm[2:2 + M]
    pt[3, :5] = perm[8:13]                  # horizon covers only 2 pages
    lane_lens = [0, 7, M * P, 6]
    rl = np.zeros((G, Qb), np.int32)
    for g in range(G):
        for r in range(Qb):
            rl[g, r] = max(lane_lens[g] - (Qb - 1 - r), 0)
    rl[2, 0] = 0                            # a padded row inside a lane
    return q, kp, vp, pt, rl


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("Qb", [1, 3, 8])
def test_ragged_matches_jax_xla_reference(Qb):
    q, kp, vp, pt, rl = _case(0, Qb)
    want = np.asarray(ragged_paged_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(rl)))
    got = pa.ragged_paged_attention(*_torch(q, kp, vp, pt, rl)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # empty rows are exact zeros on both sides
    assert (got[rl == 0] == 0).all()


@pytest.mark.parametrize("Qb", [1, 3, 8])
def test_ragged_matches_pallas_kernel_interpret(Qb):
    q, kp, vp, pt, rl = _case(1, Qb)
    want = np.asarray(ragged_paged_attention_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(rl), interpret=True))
    got = pa.ragged_paged_attention(*_torch(q, kp, vp, pt, rl)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_attention_ref_matches_jax_xla():
    rng = np.random.RandomState(2)
    B, N = 5, 16
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(N, P, H, D).astype(np.float32)
    vp = rng.randn(N, P, H, D).astype(np.float32)
    pt = rng.randint(0, N, (B, M)).astype(np.int32)
    lens = np.array([0, 1, 5, 13, M * P], np.int32)
    want = np.asarray(paged_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(lens)))
    got = pa.paged_attention_ref(*_torch(q, kp, vp, pt, lens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[0] == 0).all()


def test_cpu_tensors_route_to_plain_version_and_count():
    args = _torch(*_case(3, 3))
    before = dict(pa.PAGED_ROUTE_STATS)
    out = pa.ragged_paged_attention(*args)
    assert pa.PAGED_ROUTE_STATS["ref"] == before["ref"] + 1
    assert pa.PAGED_ROUTE_STATS["cuda"] == before["cuda"]
    torch.testing.assert_close(out, pa.ragged_paged_attention_ref(*args),
                               rtol=0, atol=0)


def test_kernel_wrapper_rejects_cpu_tensors_and_bad_shapes():
    q, kp, vp, pt, rl = _torch(*_case(4, 1))
    with pytest.raises(ValueError, match="CUDA"):
        pa.ragged_paged_attention_cuda(q, kp, vp, pt, rl)
    with pytest.raises(ValueError, match="row_lens"):
        pa.ragged_paged_attention_cuda(q, kp, vp, pt, rl[:, :0])
    with pytest.raises(ValueError, match="int8"):
        pa.ragged_paged_attention_cuda(q, kp.to(torch.int8),
                                       vp.to(torch.int8), pt, rl)
