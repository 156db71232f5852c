"""The stats form of paddle_tpu_torch's ragged paged attention vs the JAX
package.

The same numpy inputs (seeded) go through the port's routing entry on CPU
tensors (its plain PyTorch version) and through paddle_tpu's
``ragged_paged_attention_stats_xla`` and its Pallas stats kernel in
interpret mode: the ``TestStatsKernelParity`` case of
``tests/test_serving_mesh.py`` (G 2, Qb 2, H 3, D 20, page 4), f32 and
int8 in both ``fused_dequant`` settings, and a wider case with a lane
that owns nothing, empty rows and a prefill staircase.  Then the lse
merge over 2 and 3 sequence shards, each holding its pages of the pool
in local rows as the mesh core lays them out, against
``ragged_paged_attention_xla`` over the whole pool.  The CUDA kernels are
held against the plain version in ``tests/test_torch_cuda.py``.

Tolerances: (o, lse) 2e-5 absolute/relative (the same exact softmax,
summed in another order over at most 40 positions); the merge 1e-5 (a
handful of f32 operations on values of magnitude ~1).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_ops.paged_attention import (
    ragged_paged_attention_stats_kernel, ragged_paged_attention_stats_xla,
    ragged_paged_attention_xla)
from paddle_tpu_torch.ops import paged_attention as pa

TOL = dict(rtol=2e-5, atol=2e-5)
MERGE_TOL = dict(rtol=1e-5, atol=1e-5)


def _parity_case(rng, quantized):
    """``tests/test_serving_mesh.py``'s TestStatsKernelParity case."""
    G, Qb, H, D, N, P, M = 2, 2, 3, 20, 6, 4, 3
    q = rng.randn(G, Qb, H, D).astype(np.float32)
    if quantized:
        kp = rng.randint(-127, 128, (N, P, H, D)).astype(np.int8)
        vp = rng.randint(-127, 128, (N, P, H, D)).astype(np.int8)
        ks = (rng.rand(N, H) * 0.05 + 1e-3).astype(np.float32)
        vs = (rng.rand(N, H) * 0.05 + 1e-3).astype(np.float32)
    else:
        kp = rng.randn(N, P, H, D).astype(np.float32)
        vp = rng.randn(N, P, H, D).astype(np.float32)
        ks = vs = None
    pt = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    rl = np.array([[11, 12], [6, 7]], np.int32)
    ok = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    return q, kp, vp, pt, rl, ok, ks, vs


def _wide_case(rng, quantized, Qb=4):
    """G 4 lanes, H 3, D 20, page 4, M 5 over 24 pages: lane 0 owns
    every second page, lane 1 owns nothing, lane 2 is empty (row_len 0),
    lane 3 owns its first pages only; a prefill staircase of Qb rows with
    one padded row."""
    G, H, D, N, P, M = 4, 3, 20, 24, 4, 5
    q = rng.randn(G, Qb, H, D).astype(np.float32)
    if quantized:
        kp = rng.randint(-127, 128, (N, P, H, D)).astype(np.int8)
        vp = rng.randint(-127, 128, (N, P, H, D)).astype(np.int8)
        ks = (rng.rand(N, H) * 0.05 + 1e-3).astype(np.float32)
        vs = (rng.rand(N, H) * 0.05 + 1e-3).astype(np.float32)
    else:
        kp = rng.randn(N, P, H, D).astype(np.float32)
        vp = rng.randn(N, P, H, D).astype(np.float32)
        ks = vs = None
    pt = rng.permutation(np.arange(1, N))[:G * M].reshape(G, M).astype(
        np.int32)
    lane_lens = [M * P, 13, 0, 18]
    rl = np.array([[max(n - (Qb - 1 - r), 0) for r in range(Qb)]
                   for n in lane_lens], np.int32)
    rl[0, 0] = 0
    ok = np.zeros((G, M), np.int32)
    ok[0, ::2] = 1
    ok[3, :2] = 1
    ok[2] = 1
    return q, kp, vp, pt, rl, ok, ks, vs


def _jnp(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _torch(arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


CASES = [("parity", _parity_case), ("wide", _wide_case)]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name,make", CASES, ids=[c[0] for c in CASES])
def test_stats_matches_jax_xla_reference(name, make, quantized):
    args = make(np.random.RandomState(12), quantized)
    want_o, want_lse = ragged_paged_attention_stats_xla(*_jnp(args))
    o, lse = pa.ragged_paged_attention_stats(*_torch(args))
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    assert lse.dtype == torch.float32 and o.dtype == torch.float32


# (pools, fused_dequant): the int8 body in both settings
BODIES = [(False, None), (True, True), (True, False)]


@pytest.mark.parametrize("quantized,fused", BODIES,
                         ids=["f32", "int8-fused", "int8-unfused"])
@pytest.mark.parametrize("name,make", CASES, ids=[c[0] for c in CASES])
def test_stats_matches_pallas_kernel_interpret(name, make, quantized,
                                               fused):
    args = make(np.random.RandomState(13), quantized)
    want_o, want_lse = ragged_paged_attention_stats_kernel(
        *_jnp(args), interpret=True, fused_dequant=fused)
    o, lse = pa.ragged_paged_attention_stats(*_torch(args))
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_rows_with_nothing_visible_are_zero_with_neg_inf_lse(quantized):
    q, kp, vp, pt, rl, ok, ks, vs = _wide_case(np.random.RandomState(14),
                                               quantized)
    o, lse = pa.ragged_paged_attention_stats(
        *_torch((q, kp, vp, pt, rl, ok, ks, vs)))
    empty = torch.from_numpy((rl == 0) | (ok.sum(axis=1) == 0)[:, None])
    assert empty[1].all() and empty[2].all() and empty[0, 0]
    assert (o[empty] == 0).all()
    assert (lse[empty] == pa.NEG_INF).all()
    assert torch.isfinite(lse).all() and not (lse[~empty] == pa.NEG_INF).any()


def test_cpu_tensors_route_to_plain_version_and_count():
    args = _torch(_wide_case(np.random.RandomState(15), False))
    before = dict(pa.PAGED_ROUTE_STATS)
    o, lse = pa.ragged_paged_attention_stats(*args)
    assert pa.PAGED_ROUTE_STATS == dict(before,
                                        ref_stats=before["ref_stats"] + 1)
    ro, rlse = pa.ragged_paged_attention_stats_ref(*args)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)


def test_stats_kernel_wrapper_rejects_cpu_tensors_and_bad_shapes():
    q, kp, vp, pt, rl, ok, _, _ = _torch(_wide_case(np.random.RandomState(16),
                                                    False))
    with pytest.raises(ValueError, match="CUDA"):
        pa.ragged_paged_attention_stats_cuda(q, kp, vp, pt, rl, ok)
    with pytest.raises(ValueError, match="page_ok"):
        pa.ragged_paged_attention_stats_cuda(q, kp, vp, pt, rl, ok[:, :2])
    with pytest.raises(ValueError, match="row_lens"):
        pa.ragged_paged_attention_stats_cuda(q, kp, vp, pt, rl[:, :1], ok)


@pytest.mark.parametrize("sp", [2, 3])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_lse_merge_over_page_shards_equals_full_attention(sp, quantized):
    """Every lane's pages spread over ``sp`` page shards, each holding
    ``N / sp`` pages in local rows with its local row 0 reserved; each
    shard's stats over the pages it owns, merged in lse space as the mesh
    core does, equal the ragged attention over the whole pool."""
    rng = np.random.RandomState(20 + sp)
    G, Qb, H, D, P, M = 3, 4, 3, 20, 4, 6
    per = 10
    N = per * sp
    q = rng.randn(G, Qb, H, D).astype(np.float32)
    if quantized:
        kp = rng.randint(-127, 128, (N, P, H, D)).astype(np.int8)
        vp = rng.randint(-127, 128, (N, P, H, D)).astype(np.int8)
        ks = (rng.rand(N, H) * 0.05 + 1e-3).astype(np.float32)
        vs = (rng.rand(N, H) * 0.05 + 1e-3).astype(np.float32)
        scales = (ks, vs)
    else:
        kp = rng.randn(N, P, H, D).astype(np.float32)
        vp = rng.randn(N, P, H, D).astype(np.float32)
        scales = ()
    usable = [p for p in range(N) if p % per]          # not reserved
    pt = rng.permutation(usable)[:G * M].reshape(G, M).astype(np.int32)
    lane_lens = [M * P, 9, 0]
    rl = np.array([[max(n - (Qb - 1 - r), 0) for r in range(Qb)]
                   for n in lane_lens], np.int32)
    want = np.asarray(ragged_paged_attention_xla(
        *_jnp((q, kp, vp, pt, rl) + scales)))

    tq, tpt, trl = _torch((q, pt, rl))
    os_, lses = [], []
    for s in range(sp):
        own = (tpt // per) == s
        local = torch.where(own, tpt % per, torch.zeros_like(tpt))
        rows = slice(s * per, (s + 1) * per)
        loc = _torch((kp[rows], vp[rows]) + tuple(a[rows] for a in scales))
        o, lse = pa.ragged_paged_attention_stats(tq, loc[0], loc[1], local,
                                                 trl, own, *loc[2:])
        os_.append(o)
        lses.append(lse)
    from paddle_tpu_torch.distributed.mesh import pmax, psum

    mx = pmax(lses)
    w = [torch.exp(lse - m) for lse, m in zip(lses, mx)]
    num = psum([o * wi[..., None] for o, wi in zip(os_, w)])
    den = psum(w)
    ctx = num[0] / torch.clamp(den[0], min=1e-30)[..., None]
    np.testing.assert_allclose(ctx.numpy(), want, **MERGE_TOL)
    # the empty lane: NEG_INF on every shard, weight 1 each, context 0
    assert (ctx[2] == 0).all()
