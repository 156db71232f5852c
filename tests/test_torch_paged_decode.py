"""paddle_tpu_torch per-row paged attention (the split programs' decode
kernel) vs the JAX package.

The same numpy inputs (seeded) go through the port's routing entry on
CPU tensors (its plain PyTorch version ``paged_attention_ref``) and
through paddle_tpu's ``paged_attention_xla`` and its Pallas kernel
``paged_attention_kernel`` in interpret mode: native pools and int8
pools in both ``fused_dequant`` settings, empty rows, H and D off the
TPU's alignment, and a NaN scale row.  The public ops
(``ops.attention.paged_attention``, ``nn.functional.paged_attention``)
are held against the JAX package's ``F.paged_attention``.  The CUDA
kernel itself is compared with the plain version in
``tests/test_torch_cuda.py``.

Tolerance: 2e-5 absolute/relative in f32.  Both sides compute the same
exact softmax; they differ only in summation order over at most
M * P = 24 positions and D <= 20 products (f32 eps 1.2e-7), plus, for
int8 pools, where the scale multiply lands.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.pallas_ops.paged_attention import (paged_attention_kernel,
                                                       paged_attention_xla)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import attention as ops_attention
from paddle_tpu_torch.ops import paged_attention as pa

P, M = 4, 6
TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, H, D, B=6, int8=False):
    """B rows over a 24-page pool (page 0 = trash, random content), each
    row with its own table row: row 0 empty, row 1 ends mid-page, row 2
    fills its table, row 3 holds real pages PAST its length (never
    read), the rest random; with ``int8`` the pools are quantized per
    (page, head), abs-max / 127, with [N, H] f32 scales."""
    rng = np.random.RandomState(seed)
    N = 24
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(N, P, H, D).astype(np.float32)
    vp = rng.randn(N, P, H, D).astype(np.float32)
    lens = np.array([0, 7, M * P, 6] + list(rng.randint(1, M * P + 1,
                                                          B - 4)), np.int32)
    pt = np.zeros((B, M), np.int32)
    for b in range(B):
        n = 5 if b == 3 else -(-int(lens[b]) // P)
        pt[b, :n] = rng.permutation(np.arange(1, N))[:n]
    if not int8:
        return q, kp, vp, pt, lens

    def quant(pool):
        s = np.maximum(np.abs(pool).max(axis=(1, 3)) / 127.0, 1e-8)
        return (np.clip(np.round(pool / s[:, None, :, None]), -127, 127)
                .astype(np.int8), s.astype(np.float32))

    kq, ks = quant(kp)
    vq, vs = quant(vp)
    return q, kq, vq, pt, lens, ks, vs


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


SHAPES = pytest.mark.parametrize("H,D", [(2, 16), (3, 20)],
                                 ids=["aligned", "unaligned-h3-d20"])


@SHAPES
def test_ref_matches_jax_xla_and_pallas_kernel(H, D):
    args = _case(0, H, D)
    got = pa.paged_attention(*_torch(*args)).numpy()
    np.testing.assert_allclose(got, np.asarray(
        paged_attention_xla(*_jax(*args))), **TOL)
    np.testing.assert_allclose(got, np.asarray(
        paged_attention_kernel(*_jax(*args), interpret=True)), **TOL)
    # empty rows are exact zeros
    assert (got[args[4] == 0] == 0).all()


@SHAPES
@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "unfused"])
def test_int8_ref_matches_jax_xla_and_pallas_kernel(H, D, fused):
    args = _case(1, H, D, int8=True)
    got = pa.paged_attention(*_torch(*args), fused_dequant=fused).numpy()
    np.testing.assert_allclose(got, np.asarray(
        paged_attention_xla(*_jax(*args))), **TOL)
    np.testing.assert_allclose(got, np.asarray(paged_attention_kernel(
        *_jax(*args), interpret=True, fused_dequant=bool(fused))), **TOL)
    assert (got[args[4] == 0] == 0).all()


@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "unfused"])
def test_nan_scale_row_reaches_exactly_its_readers(fused):
    q, kq, vq, pt, lens, ks, vs = _case(2, 3, 20, B=8, int8=True)
    page = int(pt[2, 1])            # row 2's second page: positions 4..7
    ks = ks.copy()
    ks[page, 1] = np.nan
    args = (q, kq, vq, pt, lens, ks, vs)
    got = pa.paged_attention(*_torch(*args), fused_dequant=fused).numpy()
    want = np.asarray(paged_attention_kernel(
        *_jax(*args), interpret=True, fused_dequant=bool(fused)))
    bad = ~np.isfinite(got).all(axis=-1)                       # [B, H]
    # head 1 of every row whose table holds the page below its length
    readers = np.array([any(pt[b, j] == page and j * P < lens[b]
                            for j in range(M)) for b in range(len(lens))])
    assert readers[2] and bad[:, 1].tolist() == readers.tolist()
    assert not bad[:, [0, 2]].any()
    np.testing.assert_array_equal(bad, ~np.isfinite(want).all(axis=-1))
    np.testing.assert_allclose(got[~bad], want[~bad], **TOL)


def test_cpu_tensors_route_to_plain_version_and_count():
    args = _torch(*_case(3, 2, 16))
    before = dict(pa.PAGED_ROUTE_STATS)
    out = pa.paged_attention(*args)
    assert pa.PAGED_ROUTE_STATS == dict(before, ref=before["ref"] + 1)
    torch.testing.assert_close(out, pa.paged_attention_ref(*args),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention_cuda(*args)


@pytest.mark.parametrize("int8", [False, True], ids=["native", "int8"])
def test_public_ops_match_jax_functional(int8):
    args = _case(4, 2, 16, int8=int8)
    want = np.asarray(JF.paged_attention(*_jax(*args))._value)
    for fn in (ops_attention.paged_attention, F.paged_attention):
        got = fn(*_torch(*args)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    if int8:
        t = _torch(*args)
        with pytest.raises(ValueError, match="together"):
            F.paged_attention(*t[:5], key_scales=t[5])
