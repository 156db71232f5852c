"""paddle_tpu_torch int8 ops vs the JAX package: the KV page helpers, the
int8 page write path, the weight-only int8 matmul and int8 ragged paged
attention.

The same seeded numpy inputs go through the port's functions on CPU
tensors (its plain PyTorch versions) and through paddle_tpu's: the exact
XLA references and the Pallas kernels in interpret mode.  The CUDA
kernels themselves are compared with the plain versions in
``tests/test_torch_cuda.py`` (JAX-free, run on the card).

Tolerances, each with its reason:
- page helpers and the int8 write path: exact, byte for byte — both
  packages run the same f32 divide, round-half-to-even and clip;
- quantized matmul: 1e-5 absolute and relative — the same f32 products
  summed in another order over K = 45, or over K = 768 and 3072 at
  GPT-2-small widths in the emulation of the CUDA kernel's canonical
  order (outputs of magnitude ~1; the worst lands at a fifth of it);
- int8 ragged attention: 2e-5 absolute and relative — the same exact
  softmax over at most 24 positions, dequantized before (reference,
  ``fused_dequant=0``) or after (``fused_dequant=1``) the dots.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_ops.paged_attention import (
    ragged_paged_attention_kernel, ragged_paged_attention_xla)
from paddle_tpu.ops.pallas_ops.quantized_matmul import (
    quantized_matmul_kernel, quantized_matmul_xla)
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.text.generation import _quant_write_page as jax_write
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quantized_matmul as qm
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.text.generation import _quant_write_page

P, H, D, M = 4, 2, 16, 6
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
QMM_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch work on one thread.  Its emulations are
    long runs of small tensor ops; with the suite's workers sharing the
    CPU, an OpenMP team per worker oversubscribes it and each op pays
    for the team's rendezvous (two orders of magnitude here).  The
    cases, their inputs and their limits are unchanged."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# =============================================================================
# page helpers
# =============================================================================
@pytest.mark.parametrize("given", [False, True], ids=["own", "calibrated"])
def test_kv_page_helpers_equal_jax_exactly(given):
    rng = np.random.RandomState(0)
    page = rng.randn(8, 4, 16).astype(np.float32) * 3.0
    scales = np.array([0.01, 0.02, 0.05, 0.1], np.float32) if given \
        else None
    q_t, s_t = tkv.quantize_kv_page(page, scales)
    q_j, s_j = jkv.quantize_kv_page(page, scales)
    assert q_t.dtype == np.int8 and q_t.tobytes() == q_j.tobytes()
    assert s_t.tobytes() == s_j.tobytes()
    assert tkv.dequantize_kv_page(q_t, s_t).tobytes() == \
        jkv.dequantize_kv_page(q_j, s_j).tobytes()
    assert tkv.KV_SCALE_EPS == jkv.KV_SCALE_EPS


def test_kv_page_bytes_equal_jax():
    for dtype in ("int8", "bfloat16", "bf16", "float16", "float32"):
        assert tkv.kv_page_bytes(16, 12, 64, dtype) == \
            jkv.kv_page_bytes(16, 12, 64, dtype)
    assert tkv.kv_page_bytes(16, 12, 64, "int8") == 12336
    assert tkv.kv_page_bytes(16, 12, 64, "float32") == 49152
    with pytest.raises(InvalidArgumentError, match="int4"):
        tkv.kv_page_bytes(16, 12, 64, "int4")


# =============================================================================
# the int8 page write path
# =============================================================================
# rows 0-2: a prefill chunk inside page 2 (duplicate page index); row 3:
# page 4's last slot; rows 4-5: padded rows on the trash page 0, at
# distinct slots (their order on a shared slot is unspecified on CUDA)
_PAGE_IDX = np.array([2, 2, 2, 4, 0, 0], np.int64)
_SLOT = np.array([0, 1, 2, 3, 1, 2], np.int64)


def _write_inputs(seed):
    rng = np.random.RandomState(seed)
    pages = rng.randint(-127, 128, (6, P, H, D)).astype(np.int8)
    scales = (rng.rand(6, H) * 0.04 + 0.005).astype(np.float32)
    val = (rng.randn(6, H, D) * 3.0).astype(np.float32)
    static = (rng.rand(H) * 0.02 + 0.01).astype(np.float32)
    return pages, scales, val, static


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_quant_write_page_equals_jax_byte_for_byte(mode):
    pages, scales, val, static = _write_inputs(1)
    jp, js = jnp.asarray(pages), jnp.asarray(scales)
    tp, ts = _t(pages.copy(), scales.copy())     # the port writes in place
    # two writes in a row: the second grows some scales again and
    # requantizes what the first wrote
    for step in range(2):
        v = val * (1.0 + step)
        jp, js = jax_write(jp, js, jnp.asarray(_PAGE_IDX),
                           jnp.asarray(_SLOT), jnp.asarray(v),
                           jnp.asarray(static) if mode == "static" else None)
        out = _quant_write_page(
            tp, ts, torch.from_numpy(_PAGE_IDX), torch.from_numpy(_SLOT),
            torch.from_numpy(v),
            torch.from_numpy(static) if mode == "static" else None)
        assert out[0] is tp and out[1] is ts          # updated in place
    assert tp.numpy().tobytes() == np.asarray(jp).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    if mode == "static":
        assert ts.numpy().tobytes() == scales.tobytes()
    else:
        assert (ts.numpy() >= scales).all() and (ts.numpy() > scales).any()
    # pages nobody wrote kept their bytes
    for untouched in (1, 3, 5):
        assert (tp.numpy()[untouched] == pages[untouched]).all()


# =============================================================================
# weight-only int8 matmul
# =============================================================================
def _qmm_inputs(seed, M_=7, K=45, N=70):
    rng = np.random.RandomState(seed)
    x = rng.randn(M_, K).astype(np.float32)
    wq = rng.randint(-127, 128, (K, N)).astype(np.int8)
    ws = (rng.rand(N) * 0.02 / 127 + 1e-4).astype(np.float32)
    return x, wq, ws


def test_qmm_ref_matches_jax_xla_and_interpret_kernel():
    x, wq, ws = _qmm_inputs(0)
    got = qm.quantized_matmul_ref(*_t(x, wq, ws)).numpy()
    want = np.asarray(quantized_matmul_xla(*map(jnp.asarray, (x, wq, ws))))
    np.testing.assert_allclose(got, want, **QMM_TOL)
    kern = np.asarray(quantized_matmul_kernel(
        *map(jnp.asarray, (x, wq, ws)), interpret=True))
    np.testing.assert_allclose(got, kern, **QMM_TOL)


def test_qmm_routing_flattens_leading_dims_and_counts():
    x, wq, ws = _qmm_inputs(1, M_=6)
    x3 = torch.from_numpy(x.reshape(2, 3, -1))
    before = dict(qm.QMM_ROUTE_STATS)
    out = qm.quantized_matmul(x3, *_t(wq, ws))
    assert qm.QMM_ROUTE_STATS == {"cuda": before["cuda"],
                                  "ref": before["ref"] + 1}
    assert tuple(out.shape) == (2, 3, 70) and out.dtype == torch.float32
    want = np.asarray(quantized_matmul_xla(*map(jnp.asarray, (x, wq, ws))))
    np.testing.assert_allclose(out.reshape(6, 70).numpy(), want, **QMM_TOL)
    bf = qm.quantized_matmul(x3.bfloat16(), *_t(wq, ws))
    assert bf.dtype == torch.bfloat16


def test_qmm_kernel_wrapper_rejects_cpu_tensors_and_bad_shapes():
    x, wq, ws = _t(*_qmm_inputs(2))
    with pytest.raises(ValueError, match="CUDA"):
        qm.quantized_matmul_cuda(x, wq, ws)
    with pytest.raises(ValueError, match="K mismatch"):
        qm.quantized_matmul_cuda(x[:, :10].contiguous(), wq, ws)
    with pytest.raises(ValueError, match="w_scale"):
        qm.quantized_matmul_cuda(x, wq, ws[:5])
    with pytest.raises(TypeError, match="int8"):
        qm.quantized_matmul_cuda(x, wq.float(), ws)


def canonical_qmm(x, w_q, w_scale, kc=qm.QMM_KC):
    """The CUDA kernel's summation order, emulated on the CPU in torch: K
    in chunks of ``kc``; within a chunk a running f32 sum from 0, one
    product at a time in k order (each step summed in f64, whose product
    of an f32 and an int8 is exact, then rounded to f32: the kernel's
    fused multiply-add up to a double rounding); the chunk partials added
    in chunk order from 0 in f32; then the scale.  Every step is
    elementwise over [M, N], so a row's result depends on nothing but
    its own x row.  x [M, K] f32, w_q [K, N] int8, w_scale [N] f32."""
    M, K = x.shape
    xd, wd = x.double(), w_q.double()
    total = torch.zeros(M, w_q.shape[1], dtype=torch.float32)
    for k0 in range(0, K, kc):
        part = torch.zeros_like(total)
        for k in range(k0, min(k0 + kc, K)):
            part = (part.double() + xd[:, k, None] * wd[None, k, :]).float()
        total = total + part
    return total * w_scale[None, :]


@pytest.mark.parametrize("K,N", [(768, 768), (768, 3072), (3072, 768)],
                         ids=["proj", "fc1", "fc2"])
def test_qmm_canonical_order_matches_jax_and_is_row_independent(K, N):
    """The chunked order the CUDA kernel's decode and prefill forms share
    (``QMM_KC``) against ``quantized_matmul_xla`` and the Pallas kernel in
    interpret mode at GPT-2-small widths, and a row of an M 512 launch
    bit-equal to the same row computed alone (M 1)."""
    assert qm.QMM_KC == 64 and qm.qmm_form(16) == "decode" \
        and qm.qmm_form(17) == "prefill"
    x, wq, ws = _qmm_inputs(K + N, M_=512, K=K, N=N)
    got = canonical_qmm(*_t(x, wq, ws))
    want = np.asarray(quantized_matmul_xla(*map(jnp.asarray, (x, wq, ws))))
    np.testing.assert_allclose(got.numpy(), want, **QMM_TOL)
    kern = np.asarray(quantized_matmul_kernel(
        *map(jnp.asarray, (x, wq, ws)), interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, **QMM_TOL)
    # the order is real: not the plain version's sum to the bit
    assert not torch.equal(got, qm.quantized_matmul_ref(*_t(x, wq, ws)))
    for r in (0, 255, 511):
        one = canonical_qmm(*_t(x[r:r + 1], wq, ws))
        assert torch.equal(one[0], got[r]), r


# =============================================================================
# int8 ragged paged attention
# =============================================================================
def _int8_case(seed, Qb, nan_page=False):
    """The native attention test's lanes (empty lane, a lane ending
    mid-page, a full table, real pages past a lane's horizon, staircase
    and padded rows) over pools quantized per (page, head); optionally a
    NaN in one K scale row, read by lane 1 (head 1) only."""
    rng = np.random.RandomState(seed)
    G, N = 4, 20
    q = rng.randn(G, Qb, H, D).astype(np.float32)
    kf = rng.randn(N, P, H, D).astype(np.float32)
    vf = rng.randn(N, P, H, D).astype(np.float32)
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

    def quant(pool):
        s = np.maximum(np.abs(pool).max(axis=(1, 3)) / 127.0, 1e-8)
        qv = np.clip(np.round(pool / s[:, None, :, None]), -127, 127)
        return qv.astype(np.int8), s.astype(np.float32)

    kq, ks = quant(kf)
    vq, vs = quant(vf)
    if nan_page:
        ks[pt[1, 1], 1] = np.nan            # positions 4..7 of lane 1
    return q, kq, vq, pt, rl, ks, vs


@pytest.mark.parametrize("nan_page", [False, True], ids=["clean", "nan"])
@pytest.mark.parametrize("Qb", [1, 3, 8])
def test_int8_ragged_ref_matches_jax_xla(Qb, nan_page):
    args = _int8_case(0, Qb, nan_page)
    want = np.asarray(ragged_paged_attention_xla(*map(jnp.asarray, args)))
    got = pa.ragged_paged_attention(*_t(*args)).numpy()
    np.testing.assert_allclose(got, want, equal_nan=True, **ATTN_TOL)
    rl = args[4]
    assert (got[rl == 0] == 0).all()
    if nan_page:
        # non-finite exactly where a row sees the poisoned page
        bad = ~np.isfinite(got).all(axis=-1)
        expect = np.zeros_like(bad)
        expect[1, :, 1] = rl[1] > 4
        assert expect.any() and (bad == expect).all()


@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "unfused"])
@pytest.mark.parametrize("nan_page", [False, True], ids=["clean", "nan"])
@pytest.mark.parametrize("Qb", [1, 8])
def test_int8_ragged_ref_matches_pallas_kernel_interpret(Qb, nan_page,
                                                         fused):
    args = _int8_case(1, Qb, nan_page)
    want = np.asarray(ragged_paged_attention_kernel(
        *map(jnp.asarray, args), interpret=True, fused_dequant=bool(fused)))
    got = pa.ragged_paged_attention(*_t(*args),
                                    fused_dequant=fused).numpy()
    np.testing.assert_allclose(got, want, equal_nan=True, **ATTN_TOL)


def test_int8_routing_counts_ref_and_rejects_missing_scales():
    q, kq, vq, pt, rl, ks, vs = _t(*_int8_case(2, 3))
    before = dict(pa.PAGED_ROUTE_STATS)
    pa.ragged_paged_attention(q, kq, vq, pt, rl, ks, vs)
    assert pa.PAGED_ROUTE_STATS == {**before, "ref": before["ref"] + 1}
    with pytest.raises(ValueError, match="k_scales"):
        pa.ragged_paged_attention(q, kq, vq, pt, rl)
    with pytest.raises(ValueError, match="k_scales"):
        pa.paged_attention_ref(q[:, 0], kq, vq, pt, rl[:, 0], ks, None)
    with pytest.raises(ValueError, match="CUDA"):
        pa.ragged_paged_attention_cuda(q, kq, vq, pt, rl, ks, vs)
    with pytest.raises(ValueError, match="k_scales"):
        pa.ragged_paged_attention_cuda(q, kq, vq, pt, rl, ks[:, :1], vs)
    with pytest.raises(ValueError, match="int8 pools only"):
        pa.ragged_paged_attention_cuda(q, kq.float(), vq.float(), pt, rl,
                                       ks, vs)
