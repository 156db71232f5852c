"""paddle_tpu_torch on the card: the CUDA kernels against their plain
PyTorch versions, the engine's streams against the dense ``generate``
(ragged, split and speculative, native and int8), and a training step
against the same step on the CPU.

Every test here is marked ``cuda`` and skips itself where
``torch.cuda.is_available()`` is False.  The file imports no JAX (the
machine with the card has none); run it there without the suite's
conftest, which imports JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: the paged attention kernels (ragged and per row) vs their
plain version 1e-4 in f32 (the same f32 products summed in another
order, online softmax over up to 1024 positions; int8 pools add the scale
multiply before or after the dot) and 2e-2 in bf16 (the kernel rounds its
f32 result to bf16, 8 mantissa bits).  The
weight-only int8 matmul: 1e-4 absolute and relative in f32 (f32 sums
over K <= 3072 in another order), 1e-2 in bf16.  The flash attention
kernels: 1e-4 in f32, 2e-2 in bf16 and 4e-3 in fp16, times max(1, the
largest reference value) (f32 sums over up to 1024 keys or queries in another
order, the f32 bodies in 3xTF32 on the tensor cores, about 2^-21 of a
product; in bf16 the outputs are rounded to 8 mantissa bits, and the
three bodies, which run on the tensor cores, also round P and dS to bf16
before their second product, where the plain version keeps them in f32
— ``tests/test_torch_flash_tc_numerics.py`` shows on the CPU that this
fits the limit; the fp16 bodies do the same in fp16, 11 significant bits,
``tests/test_torch_flash_fp16.py``); besides, each whole output within
``chip_smoke.FLASH_REL_L2`` of its plain version in relative L2 norm: in
bf16 1e-2 (the roundings land at 1.8e-3 to 2.8e-3 in the CPU emulation,
a dropped key tile at 0.18), in fp16 2e-3, in f32 2e-4 (3xTF32 lands at most at 1.9e-6
in the CPU emulation, one-pass TF32 at 3.6e-4 and more,
``tests/test_torch_flash_f32tc_numerics.py``); lse 1e-4; their dropout
bits must equal
``_keep_mask``'s exactly.  The scale-shift kernel (row t) must
equal its plain version bit for bit (the same two f32 roundings and one
cast).  Streams must be equal token for token.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quantized_matmul as qm
from paddle_tpu_torch.ops import scale_shift as ss

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}
# head dims past 128, the D 256 instances of the paged kernels (DC 8): a
# multiple of 16 (int8 rows in 16-byte loads), one that is not (D 200:
# byte by byte), and the widest
WIDE_SHAPES = [(3, 160, 16, 4), (2, 200, 8, 5), (2, 256, 16, 4)]
WIDE_IDS = ["d160", "d200", "d256"]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(seed, G, Qb, H, D, P, M, dtype):
    """Lanes with horizons from empty to the full table, staircase rows,
    one padded row, real pages past lane 1's horizon and random content
    in the trash page 0."""
    rng = np.random.RandomState(seed)
    lane_lens = [0, min(7, M * P), M * P] + [
        int(x) for x in rng.randint(1, M * P + 1, G - 3)]
    N = 1 + G * M
    pt = np.zeros((G, M), np.int32)
    perm = rng.permutation(np.arange(1, N))
    for g in range(G):
        n = M if g == 1 else -(-lane_lens[g] // P)
        pt[g, :n] = perm[g * M:g * M + n]
    rl = np.zeros((G, Qb), np.int32)
    for g in range(G):
        for r in range(Qb):
            rl[g, r] = max(lane_lens[g] - (Qb - 1 - r), 0)
    rl[2, 0] = 0
    q = rng.randn(G, Qb, H, D).astype(np.float32)
    kp = rng.randn(N, P, H, D).astype(np.float32)
    vp = rng.randn(N, P, H, D).astype(np.float32)
    dev = "cuda"
    return (torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(kp).to(dev, dtype),
            torch.from_numpy(vp).to(dev, dtype),
            torch.from_numpy(pt).to(dev), torch.from_numpy(rl).to(dev))


# rows a lane: the decode form up to 15 (1, 4 or 8 rows a CTA), the
# prefill form from 16 (STATS_PREFILL_ROWS)
RAGGED_QB = [1, 3, 8, 15, 16, 17, 64]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Qb", RAGGED_QB)
@pytest.mark.parametrize("H,D,P,M", [(2, 16, 4, 6), (12, 64, 16, 8),
                                     (4, 128, 16, 4), (3, 48, 5, 7)]
                         + WIDE_SHAPES,
                         ids=["test-shape", "gpt2", "d128", "odd"]
                         + WIDE_IDS)
def test_kernel_matches_plain_version(H, D, P, M, Qb, dtype):
    args = _case(0, 5, Qb, H, D, P, M, dtype)
    before = pa.PAGED_ROUTE_STATS["cuda"]
    out = pa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.PAGED_ROUTE_STATS["cuda"] == before + 1
    ref = pa.ragged_paged_attention_ref(
        *(a.float() if a.is_floating_point() else a for a in args))
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=TOL[dtype])
    assert (out[args[4] == 0] == 0).all()
    assert out.dtype == dtype and out.shape == args[0].shape


def _int8(args):
    """The case's pools quantized per (page, head), abs-max / 127, with
    their [N, H] f32 scales."""
    q, kp, vp, pt, rl = args

    def quant(pool):
        x = pool.float()
        s = (x.abs().amax(dim=(1, 3)) / 127.0).clamp(min=1e-8)    # [N, H]
        qv = torch.round(x / s[:, None, :, None]).clamp(-127, 127)
        return qv.to(torch.int8).contiguous(), s.contiguous()

    kq, ks = quant(kp)
    vq, vs = quant(vp)
    return q, kq, vq, pt, rl, ks, vs


@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "unfused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Qb", RAGGED_QB)
@pytest.mark.parametrize("H,D,P,M", [(2, 16, 4, 6), (12, 64, 16, 8),
                                     (4, 128, 16, 4), (3, 48, 5, 7),
                                     (2, 20, 4, 5)] + WIDE_SHAPES,
                         ids=["test-shape", "gpt2", "d128", "odd",
                              "bytewise-d20"] + WIDE_IDS)
def test_int8_kernel_matches_plain_version(H, D, P, M, Qb, dtype, fused):
    q, kq, vq, pt, rl, ks, vs = _int8(_case(0, 5, Qb, H, D, P, M, dtype))
    before = dict(pa.PAGED_ROUTE_STATS)
    out = pa.ragged_paged_attention(q, kq, vq, pt, rl, ks, vs,
                                    fused_dequant=fused)
    torch.cuda.synchronize()
    assert pa.PAGED_ROUTE_STATS["cuda_int8"] == before["cuda_int8"] + 1
    assert pa.PAGED_ROUTE_STATS["cuda"] == before["cuda"]
    ref = pa.ragged_paged_attention_ref(q.float(), kq, vq, pt, rl, ks, vs)
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=TOL[dtype])
    assert (out[rl == 0] == 0).all()
    assert out.dtype == dtype and out.shape == q.shape


@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "unfused"])
def test_int8_kernel_nan_scale_reaches_exactly_its_readers(fused):
    q, kq, vq, pt, rl, ks, vs = _int8(_case(3, 5, 8, 12, 64, 16, 8,
                                            torch.float32))
    page = int(pt[3, 1])                 # lane 3's second page
    ks[page, 5] = float("nan")
    out = pa.ragged_paged_attention(q, kq, vq, pt, rl, ks, vs,
                                    fused_dequant=fused)
    ref = pa.ragged_paged_attention_ref(q, kq, vq, pt, rl, ks, vs)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(out).all(dim=-1)                 # [G, Qb, H]
    want = ~torch.isfinite(ref).all(dim=-1)
    assert want.any() and torch.equal(bad, want)
    # the readers: head 5 of lane 3's rows that see past position 16
    assert torch.equal(bad[3, :, 5], rl[3] > 16)
    assert not bad[:, :, [h for h in range(12) if h != 5]].any()
    ok = ~want[..., None].expand_as(out)
    torch.testing.assert_close(out[ok], ref[ok], rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 37, 72, 512])
@pytest.mark.parametrize("K,N", [(768, 768), (768, 3072), (3072, 768),
                                 (45, 70)],
                         ids=["proj", "fc1", "fc2", "odd"])
def test_qmm_kernel_matches_plain_version(K, N, M, dtype):
    rng = np.random.RandomState(M + K)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(
        "cuda", dtype)
    wq = torch.from_numpy(rng.randint(-127, 128, (K, N)).astype(
        np.int8)).cuda()
    ws = torch.from_numpy((rng.rand(N) * 0.02 / 127).astype(
        np.float32)).cuda()
    before = dict(qm.QMM_ROUTE_STATS)
    out = qm.quantized_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert qm.QMM_ROUTE_STATS == {"cuda": before["cuda"] + 1,
                                  "ref": before["ref"]}
    ref = qm.quantized_matmul_ref(x.float(), wq, ws)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
    assert out.dtype == dtype and out.shape == (M, N)
    # a row's result does not depend on the other rows of the launch, nor
    # on the form that computed it (the decode form up to 16 rows, the
    # prefill form from 17; 72 is 8 decode rows beside a 64-row chunk)
    one = qm.quantized_matmul(x[M // 2:M // 2 + 1].contiguous(), wq, ws)
    assert torch.equal(one[0], out[M // 2])


def _lanes_case(seed, lane_lens, Qb, H, D, P, M, dtype):
    """Lanes of the given lengths (a prefill staircase of Qb rows), each
    on its own pages, random content in the trash page 0."""
    rng = np.random.RandomState(seed)
    G = len(lane_lens)
    N = 1 + G * M
    perm = rng.permutation(np.arange(1, N))
    pt = np.zeros((G, M), np.int32)
    for g, n in enumerate(lane_lens):
        k = -(-n // P)
        pt[g, :k] = perm[g * M:g * M + k]
    rl = np.array([[max(n - (Qb - 1 - r), 0) for r in range(Qb)]
                   for n in lane_lens], np.int32)
    q, kp, vp = (torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
                 for a in (rng.randn(G, Qb, H, D), rng.randn(N, P, H, D),
                           rng.randn(N, P, H, D)))
    return q, kp, vp, torch.from_numpy(pt).cuda(), torch.from_numpy(rl).cuda()


def _check_ragged(args, fused=1):
    quant = args[1].dtype == torch.int8
    kw = {"fused_dequant": fused} if quant else {}
    out = pa.ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    q = args[0].float()
    ref = pa.ragged_paged_attention_ref(
        q, *(a.float() if a.is_floating_point() and not quant else a
             for a in args[1:]))
    torch.testing.assert_close(out.float(), ref, rtol=0,
                               atol=TOL[args[0].dtype])
    assert (out[args[4] == 0] == 0).all()
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("Qb", [1, 16])
def test_kernel_takes_a_table_wider_than_the_stats_limit(Qb, quant):
    """#1 has no page-table limit: 4100 one-position pages a lane (the
    stats kernel stops at STATS_MAX_PAGES = 4096)."""
    args = _lanes_case(4, [0, 4100, 2501, 4097], Qb, 2, 64, 1, 4100,
                       torch.float32)
    assert args[3].shape[1] > pa.STATS_MAX_PAGES
    _check_ragged(_int8(args) if quant else args)


def _decode_layout(D, item, Qb, M, P):
    """The decode form's (cluster, warps, rows) for a call, from the
    kernel library (``ptt_paged_decode_layout``, the launch's own rule)."""
    import ctypes

    from paddle_tpu_torch.ops import _build

    vals = [ctypes.c_int() for _ in range(3)]
    fn = _build.load_library("paged_attention").ptt_paged_decode_layout
    assert fn(D, item, Qb, M, P, *map(ctypes.byref, vals)) == 0
    return tuple(v.value for v in vals)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("Qb", [1, 8, 15])
@pytest.mark.parametrize("D", [64, 256])
def test_decode_form_lanes_of_length_0_and_1_in_a_cluster(D, Qb, quant):
    """A 1024-position table splits each lane's walk over a cluster of 2
    to 4 CTAs: lanes of 0 and 1 positions leave all but rank 0's first
    warp (or all) idle, and still merge to exact zeros and to the one
    visible value."""
    args = _lanes_case(5, [0, 1, 1024, 33, 1, 0], Qb, 4, D, 16, 64,
                       torch.float32)
    assert _decode_layout(D, 1 if quant else 4, Qb, 64, 16)[0] > 1
    out = _check_ragged(_int8(args) if quant else args)
    assert (out[0] == 0).all() and (out[5] == 0).all()


def _lane_alone_equal(fn, args, **kw):
    full = fn(*args, **kw)
    for g in range(args[0].shape[0]):
        one = fn(*(a[g:g + 1] if i in (0, 3, 4) else a
                   for i, a in enumerate(args)), **kw)
        assert torch.equal(one[0], full[g]), g


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("Qb", [1, 8, 16, 64])
@pytest.mark.parametrize("D", [64, 256])
def test_a_lane_alone_equals_the_lane_in_its_batch(D, Qb, quant):
    """Batch invariance, bit for bit: the decode form's split and the
    prefill form's walk depend on the lane's own rows, never on the
    other lanes of the launch (#1 and #1q)."""
    args = _lanes_case(6, [0, 1, 17, 300, 777, 1024], Qb, 4, D, 16, 64,
                       torch.float32)
    if quant:
        args = _int8(args)
    _lane_alone_equal(pa.ragged_paged_attention_cuda, args,
                      **({"fused_dequant": 1} if quant else {}))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("D", [64, 256])
def test_a_row_alone_equals_the_row_in_its_batch(D, quant):
    """The same for the per-row kernel (#2 and #2q)."""
    args = _rows(_lanes_case(7, [0, 1, 17, 300, 777, 1024], 1, 4, D, 16,
                             64, torch.float32))
    if quant:
        q, kq, vq, pt, sl, ks, vs = _int8(args)
        args = (q, kq, vq, pt, sl, ks, vs)
    _lane_alone_equal(pa.paged_attention_cuda, args,
                      **({"fused_dequant": 0} if quant else {}))


def test_decode_form_layout_matches_the_library():
    """The library's layouts: at a 1024-position table the clusters the
    CPU emulation (tests/test_torch_paged_forms.py) deals tiles over —
    4 tiles of a full table a warp for f32 pools, 2 for bf16 and int8 —
    rows a CTA by the Qb bucket, one CTA for a small table, at most 8
    whatever the table."""
    import itertools

    for (D, item), want in {(64, 4): (2, 4), (64, 2): (4, 4),
                            (64, 1): (4, 4), (256, 4): (4, 2),
                            (256, 1): (4, 4)}.items():
        for Qb, rows in ((1, 1), (2, 4), (4, 4), (5, 8), (15, 8)):
            assert _decode_layout(D, item, Qb, 64, 16) == want + (rows,)
        assert _decode_layout(D, item, 1, 5, 4)[0] == 1
        assert _decode_layout(D, item, 1, 4100, 16)[0] == 8
    for D, item, Qb, M, P in itertools.product(
            [1, 32, 33, 64, 128, 129, 256], [1, 2, 4], [1, 2, 4, 5, 15],
            [1, 3, 64, 4100], [1, 16]):
        cs, warps, rows = _decode_layout(D, item, Qb, M, P)
        assert 1 <= cs <= 8 and warps in (2, 4) and rows in (1, 4, 8)


def test_int8_and_qmm_wrappers_reject_what_the_kernels_do_not_take():
    q, kq, vq, pt, rl, ks, vs = _int8(_case(1, 4, 1, 2, 16, 4, 6,
                                            torch.float32))
    with pytest.raises(ValueError, match="k_scales"):
        pa.ragged_paged_attention(q, kq, vq, pt, rl)
    with pytest.raises(ValueError, match="k_scales"):
        pa.ragged_paged_attention(q, kq, vq, pt, rl, ks[:, :1], vs)
    with pytest.raises(ValueError, match="contiguous"):
        pa.ragged_paged_attention(q, kq, vq, pt, rl, ks.t().contiguous().t(),
                                  vs)
    x = torch.zeros(4, 16, device="cuda")
    wq = torch.zeros(16, 8, dtype=torch.int8, device="cuda")
    ws = torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        qm.quantized_matmul_cuda(torch.zeros(16, 4, device="cuda").t(), wq,
                                 ws)
    with pytest.raises(ValueError, match="w_scale"):
        qm.quantized_matmul_cuda(x, wq, ws[:4])
    with pytest.raises(TypeError, match="int8"):
        qm.quantized_matmul_cuda(x, wq.float(), ws)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    args = list(_case(1, 4, 1, 2, 16, 4, 6, torch.float32))
    strided = torch.zeros(*args[0].shape[:-1], 2 * args[0].shape[-1],
                          device="cuda")[..., ::2]      # same shape
    with pytest.raises(ValueError, match="contiguous"):
        pa.ragged_paged_attention(strided, *args[1:])
    with pytest.raises(ValueError, match="head_dim 257 > 256"):
        big = torch.zeros(4, 1, 1, 257, device="cuda")
        pools = torch.zeros(8, 4, 1, 257, device="cuda")
        pa.ragged_paged_attention(big, pools, pools, args[3], args[4])


def test_engine_streams_equal_generate_on_the_card():
    from paddle_tpu_torch.serving import create_serving_engine
    from paddle_tpu_torch.text.generation import generate
    from paddle_tpu_torch.text.models import GPTModel

    m = GPTModel(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
                 ffn_size=128, max_seq_len=128, device="cuda", seed=7)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 64, (n,)).astype(np.int32)
               for n in (1, 3, 9, 17, 30)]
    for sync_mode in (True, False):
        eng = create_serving_engine(m, page_size=4, max_batch_size=4,
                                    prefill_chunk=8, eos_id=-1,
                                    sync_mode=sync_mode)
        _zero_counts()
        ids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        outs = eng.drain()
        dispatches = eng.stats()["metrics"]["ragged"]["steps"]
        assert pa.PAGED_ROUTE_STATS == _counts(cuda=2 * dispatches)
        assert eng.cache.pages_in_use == 0
        for p, rid in zip(prompts, ids):
            want = generate(m, p[None], max_new_tokens=12,
                            end_id=-1)[0][0].cpu().numpy()
            np.testing.assert_array_equal(outs[rid], want)


def test_int8_engine_streams_equal_generate_quant_on_the_card():
    from paddle_tpu_torch.serving import create_serving_engine
    from paddle_tpu_torch.slim import export_serving_quant
    from paddle_tpu_torch.text.generation import generate
    from paddle_tpu_torch.text.models import GPTModel

    m = GPTModel(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
                 ffn_size=128, max_seq_len=128, device="cuda", seed=7)
    rng = np.random.RandomState(2)
    quant = export_serving_quant(m, calib_prompts=rng.randint(1, 64, (4, 24)))
    prompts = [rng.randint(1, 64, (n,)).astype(np.int32)
               for n in (1, 3, 9, 17, 30)]
    streams = {}
    for mode, qs in (("static", quant), ("dynamic", None)):
        for sync_mode in (True, False):
            eng = create_serving_engine(
                m, page_size=4, max_batch_size=4, prefill_chunk=8,
                eos_id=-1, sync_mode=sync_mode, kv_cache_dtype="int8",
                weight_dtype="int8", quant_scales=qs)
            _zero_counts()
            qm.QMM_ROUTE_STATS.update(cuda=0, ref=0)
            ids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
            outs = eng.drain()
            dispatches = eng.stats()["metrics"]["ragged"]["steps"]
            assert pa.PAGED_ROUTE_STATS == _counts(cuda_int8=2 * dispatches)
            assert qm.QMM_ROUTE_STATS == {"cuda": 12 * dispatches, "ref": 0}
            assert eng.cache.pages_in_use == 0
            streams[mode, sync_mode] = [outs[r] for r in ids]
    for mode in ("static", "dynamic"):
        for a, b in zip(streams[mode, True], streams[mode, False]):
            np.testing.assert_array_equal(a, b)
    for p, got in zip(prompts, streams["static", True]):
        want = generate(m, p[None], max_new_tokens=12, end_id=-1,
                        quant=quant)[0][0].cpu().numpy()
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the per-row paged attention kernel (bodies #2, #2q)
# --------------------------------------------------------------------------
def _zero_counts():
    for key in pa.PAGED_ROUTE_STATS:
        pa.PAGED_ROUTE_STATS[key] = 0


def _counts(**nonzero):
    return {key: nonzero.get(key, 0) for key in pa.PAGED_ROUTE_STATS}


def _rows(args):
    """A Qb=1 ragged case as per-row inputs: q [B, H, D], seq_lens [B]."""
    q, kp, vp, pt, rl = args
    return q[:, 0].contiguous(), kp, vp, pt, rl[:, 0].contiguous()


def _chunk_rows(seed, C, H, D, P, M, dtype):
    """A prefill chunk: C rows (at most what M - 1 pages hold) of one
    sequence sharing its table row, row r at position off + r seeing
    min(off + r + 1, valid_len) positions (the chunk's tail is padding
    past valid_len)."""
    rng = np.random.RandomState(seed)
    N = 1 + M + 2
    row = np.zeros((M,), np.int32)
    row[:M - 1] = rng.permutation(np.arange(1, N))[:M - 1]
    cap = (M - 1) * P               # positions the allocated pages hold
    C = min(C, cap - 2)
    off = cap - C - 2
    valid = off + C - C // 8
    lens = np.minimum(off + np.arange(C) + 1, valid).astype(np.int32)
    dev = "cuda"
    return (torch.from_numpy(rng.randn(C, H, D).astype(np.float32)).to(
                dev, dtype),
            torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32)).to(
                dev, dtype),
            torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32)).to(
                dev, dtype),
            torch.from_numpy(np.tile(row, (C, 1))).to(dev),
            torch.from_numpy(lens).to(dev))


_DECODE_SHAPES = pytest.mark.parametrize(
    "H,D,P,M", [(2, 16, 4, 6), (12, 64, 16, 8), (4, 128, 16, 4),
                (3, 48, 5, 7), (2, 20, 4, 5)] + WIDE_SHAPES,
    ids=["test-shape", "gpt2", "d128", "odd", "bytewise-d20"] + WIDE_IDS)


def _decode_inputs(kind, H, D, P, M, dtype):
    if kind == "chunk":
        return _chunk_rows(5, 64, H, D, P, M, dtype)
    return _rows(_case(0, {"rows1": 4, "rows33": 33}[kind], 1, H, D, P, M,
                       dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["rows1", "rows33", "chunk"])
@_DECODE_SHAPES
def test_decode_kernel_matches_plain_version(H, D, P, M, kind, dtype):
    args = _decode_inputs(kind, H, D, P, M, dtype)
    _zero_counts()
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.PAGED_ROUTE_STATS == _counts(cuda_decode=1)
    ref = pa.paged_attention_ref(
        *(a.float() if a.is_floating_point() else a for a in args))
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=TOL[dtype])
    assert (out[args[4] == 0] == 0).all()
    assert out.dtype == dtype and out.shape == args[0].shape


@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "unfused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["rows1", "rows33", "chunk"])
@_DECODE_SHAPES
def test_int8_decode_kernel_matches_plain_version(H, D, P, M, kind, dtype,
                                                  fused):
    q, kp, vp, pt, sl = _decode_inputs(kind, H, D, P, M, dtype)
    _, kq, vq, _, _, ks, vs = _int8((q, kp, vp, pt, sl))
    _zero_counts()
    out = pa.paged_attention(q, kq, vq, pt, sl, ks, vs, fused_dequant=fused)
    torch.cuda.synchronize()
    assert pa.PAGED_ROUTE_STATS == _counts(cuda_decode_int8=1)
    ref = pa.paged_attention_ref(q.float(), kq, vq, pt, sl, ks, vs)
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=TOL[dtype])
    assert (out[sl == 0] == 0).all()
    assert out.dtype == dtype and out.shape == q.shape


@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "unfused"])
def test_int8_decode_kernel_nan_scale_reaches_exactly_its_readers(fused):
    q, kp, vp, pt, sl = _chunk_rows(7, 64, 12, 64, 16, 8, torch.float32)
    _, kq, vq, _, _, ks, vs = _int8((q, kp, vp, pt, sl))
    page = int(pt[0, 3])                 # positions 48..63
    ks[page, 5] = float("nan")
    out = pa.paged_attention(q, kq, vq, pt, sl, ks, vs, fused_dequant=fused)
    ref = pa.paged_attention_ref(q, kq, vq, pt, sl, ks, vs)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(out).all(dim=-1)                 # [C, H]
    want = ~torch.isfinite(ref).all(dim=-1)
    assert want.any() and torch.equal(bad, want)
    # the readers: head 5 of the rows that see past position 48
    assert torch.equal(bad[:, 5], sl > 48) and not bad[:2, 5].any()
    assert not bad[:, [h for h in range(12) if h != 5]].any()
    ok = ~want[..., None].expand_as(out)
    torch.testing.assert_close(out[ok], ref[ok], rtol=0, atol=1e-4)


def test_decode_wrapper_rejects_what_the_kernel_does_not_take():
    q, kp, vp, pt, sl = _rows(_case(1, 4, 1, 2, 16, 4, 6, torch.float32))
    _, kq, vq, _, _, ks, vs = _int8((q, kp, vp, pt, sl))
    strided = torch.zeros(q.shape[0], q.shape[1], 2 * q.shape[2],
                          device="cuda")[..., ::2]      # same shape
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(strided, kp, vp, pt, sl)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pa.paged_attention(q.half(), kp.half(), vp.half(), pt, sl)
    with pytest.raises(TypeError, match="pools"):
        pa.paged_attention(q, kp.bfloat16(), vp.bfloat16(), pt, sl)
    with pytest.raises(ValueError, match="seq_lens"):
        pa.paged_attention(q, kp, vp, pt, sl[:2])
    with pytest.raises(ValueError, match="page_tables"):
        pa.paged_attention(q, kp, vp, pt[:2], sl)
    with pytest.raises(ValueError, match="is on cpu"):
        pa.paged_attention(q, kp, vp, pt.cpu(), sl)
    with pytest.raises(ValueError, match="k_scales"):
        pa.paged_attention(q, kq, vq, pt, sl)
    with pytest.raises(ValueError, match="head_dim 257 > 256"):
        big = torch.zeros(4, 1, 257, device="cuda")
        pools = torch.zeros(8, 4, 1, 257, device="cuda")
        pa.paged_attention(big, pools, pools, pt, sl)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention_cuda(q.cpu(), kp.cpu(), vp.cpu(), pt.cpu(),
                                sl.cpu())
    with pytest.raises(ValueError, match="q must be"):
        pa.paged_attention_cuda(q[:, None], kp, vp, pt, sl)


def _engine_case():
    from paddle_tpu_torch.text.models import GPTModel

    m = GPTModel(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
                 ffn_size=128, max_seq_len=128, device="cuda", seed=7)
    rng = np.random.RandomState(2)
    pat = rng.randint(1, 64, (5,)).astype(np.int32)
    prompts = [rng.randint(1, 64, (n,)).astype(np.int32)
               for n in (1, 3, 9, 17, 30)] + [np.tile(pat, 4)]
    return m, prompts


def test_wide_head_engine_streams_equal_generate_on_the_card():
    """A 2-layer GPT with head dim 256 (hidden 512 over 2 heads) through
    the ragged engine, native and int8_static: every attention call on
    the D 256 instances of #1 or #1q, streams equal to ``generate``
    (``generate(quant=...)``); a head dim of 260 is refused when the
    engine is built."""
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.serving import create_serving_engine
    from paddle_tpu_torch.slim import export_serving_quant
    from paddle_tpu_torch.text.generation import generate
    from paddle_tpu_torch.text.models import GPTModel

    m = GPTModel(vocab_size=64, hidden_size=512, num_layers=2, num_heads=2,
                 ffn_size=256, max_seq_len=128, device="cuda", seed=7)
    rng = np.random.RandomState(2)
    quant = export_serving_quant(m, calib_prompts=rng.randint(1, 64, (4, 24)))
    prompts = [rng.randint(1, 64, (n,)).astype(np.int32)
               for n in (1, 3, 9, 17, 30)]
    for qs in (None, quant):
        kw = {} if qs is None else dict(kv_cache_dtype="int8",
                                        weight_dtype="int8", quant_scales=qs)
        eng = create_serving_engine(m, page_size=4, max_batch_size=4,
                                    prefill_chunk=8, eos_id=-1, **kw)
        _zero_counts()
        ids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        outs = eng.drain()
        dispatches = eng.stats()["metrics"]["ragged"]["steps"]
        key = "cuda" if qs is None else "cuda_int8"
        assert pa.PAGED_ROUTE_STATS == _counts(**{key: 2 * dispatches})
        assert eng.cache.pages_in_use == 0
        for p, rid in zip(prompts, ids):
            want = generate(m, p[None], max_new_tokens=12, end_id=-1,
                            quant=qs)[0][0].cpu().numpy()
            np.testing.assert_array_equal(outs[rid], want)
    wide = GPTModel(vocab_size=64, hidden_size=520, num_layers=1,
                    num_heads=2, ffn_size=64, max_seq_len=32, device="cuda")
    with pytest.raises(InvalidArgumentError, match="head_dim 260 > 256"):
        create_serving_engine(wide, page_size=4, max_batch_size=2)


@pytest.mark.parametrize("knobs", [
    dict(ragged=False), dict(ragged=False, sync_mode=True),
    dict(fused_steps=4), dict(ragged=False, spec_decode=4)],
    ids=["split", "split-sync", "fused4", "split-spec4"])
def test_split_engine_streams_equal_generate_on_the_card(knobs):
    from paddle_tpu_torch.serving import create_serving_engine
    from paddle_tpu_torch.text.generation import generate

    m, prompts = _engine_case()
    eng = create_serving_engine(m, page_size=4, max_batch_size=4,
                                prefill_chunk=8, eos_id=-1, **knobs)
    _zero_counts()
    ids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
    outs = eng.drain()
    calls = eng.stats()["programs"]
    forwards = (calls["decode"] + calls["prefill"] + calls["spec_verify"]
                + eng.fused_steps * calls["decode_fused"])
    assert forwards > 0 and calls["ragged_step"] == 0
    assert pa.PAGED_ROUTE_STATS == _counts(cuda_decode=2 * forwards)
    if "fused_steps" in knobs:
        assert calls["decode_fused"] > 0
    if "spec_decode" in knobs:
        assert calls["spec_verify"] > 0
    assert eng.cache.pages_in_use == 0
    for p, rid in zip(prompts, ids):
        want = generate(m, p[None], max_new_tokens=12,
                        end_id=-1)[0][0].cpu().numpy()
        np.testing.assert_array_equal(outs[rid], want)


def test_spec_engine_streams_equal_generate_on_the_card():
    """The default ragged engine with speculation: the verify rows fold
    into the ragged step (body #1 only)."""
    from paddle_tpu_torch.serving import create_serving_engine
    from paddle_tpu_torch.text.generation import generate

    m, prompts = _engine_case()
    eng = create_serving_engine(m, page_size=4, max_batch_size=4,
                                prefill_chunk=8, eos_id=-1, spec_decode=4)
    _zero_counts()
    ids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
    outs = eng.drain()
    steps = eng.stats()["programs"]["ragged_step"]
    assert pa.PAGED_ROUTE_STATS == _counts(cuda=2 * steps)
    assert eng.stats()["spec"]["drafted"] > 0
    assert eng.cache.pages_in_use == 0
    for p, rid in zip(prompts, ids):
        want = generate(m, p[None], max_new_tokens=12,
                        end_id=-1)[0][0].cpu().numpy()
        np.testing.assert_array_equal(outs[rid], want)


# --------------------------------------------------------------------------
# the stats form of the ragged kernel (bodies #3, #3q)
# --------------------------------------------------------------------------
# lse vs the plain version: the same f32 scores, exp-summed in another
# order (values up to ~10)
LSE_TOL = 1e-5


# which table entries a shard owns: every second one, the first half (as
# the allocator hands out runs), a run that starts one page in (mid-tile
# in the table's positions), one page, none
OWNERSHIP = ("every-second", "runs", "run-mid-tile", "one-page", "none")


def _page_ok(pt, owner_none=3, pattern="every-second"):
    """The ``pattern``'s table entries owned in every lane; lane
    ``owner_none`` owns nothing."""
    m = torch.arange(pt.shape[1], device=pt.device)
    own = {"every-second": m % 2 == 0,
           "runs": m < (pt.shape[1] + 1) // 2,
           "run-mid-tile": (m >= 1) & (m < pt.shape[1] - 1),
           "one-page": m == pt.shape[1] // 2,
           "none": m < 0}[pattern]
    ok = own[None, :].expand_as(pt).to(torch.int32).contiguous()
    ok[owner_none] = 0
    return ok


def _check_stats(o, lse, ref_o, ref_lse, rl, ok, dtype):
    torch.testing.assert_close(o.float(), ref_o.float(), rtol=0,
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=LSE_TOL)
    # rows with nothing visible: no visible length or no owned page
    P_any = (ok != 0).any(dim=1)[:, None].expand_as(rl)
    empty = (rl == 0) | ~P_any
    assert empty.any() and (o[empty] == 0).all()
    assert (lse[empty] == pa.NEG_INF).all()
    assert lse.dtype == torch.float32 and lse.shape == rl.shape + (
        o.shape[2],)


@pytest.mark.parametrize("pattern", OWNERSHIP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Qb", [1, 3, 8, 64])
@pytest.mark.parametrize("H,D,P,M", [(2, 16, 4, 6), (12, 64, 16, 8),
                                     (6, 64, 16, 8), (4, 128, 16, 4),
                                     (3, 48, 5, 7)] + WIDE_SHAPES,
                         ids=["test-shape", "gpt2", "gpt2-tp2", "d128",
                              "odd"] + WIDE_IDS)
def test_stats_kernel_matches_plain_version(H, D, P, M, Qb, dtype, pattern):
    q, kp, vp, pt, rl = _case(0, 5, Qb, H, D, P, M, dtype)
    ok = _page_ok(pt, pattern=pattern)
    _zero_counts()
    o, lse = pa.ragged_paged_attention_stats(q, kp, vp, pt, rl, ok)
    torch.cuda.synchronize()
    assert pa.PAGED_ROUTE_STATS == _counts(cuda_stats=1)
    ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(
        q.float(), kp.float(), vp.float(), pt, rl, ok)
    _check_stats(o, lse, ref_o, ref_lse, rl, ok, dtype)
    assert o.dtype == dtype and o.shape == q.shape


@pytest.mark.parametrize("pattern", ["every-second", "runs"])
@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "unfused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Qb", [1, 8, 17, 64])
@pytest.mark.parametrize("H,D,P,M", [(2, 16, 4, 6), (12, 64, 16, 8),
                                     (6, 64, 16, 8), (3, 48, 5, 7),
                                     (2, 20, 4, 5), (4, 128, 16, 4)]
                         + WIDE_SHAPES,
                         ids=["test-shape", "gpt2", "gpt2-tp2", "odd",
                              "bytewise-d20", "d128"] + WIDE_IDS)
def test_int8_stats_kernel_matches_plain_version(H, D, P, M, Qb, dtype,
                                                 fused, pattern):
    q, kq, vq, pt, rl, ks, vs = _int8(_case(0, 5, Qb, H, D, P, M, dtype))
    ok = _page_ok(pt, pattern=pattern)
    _zero_counts()
    o, lse = pa.ragged_paged_attention_stats(q, kq, vq, pt, rl, ok, ks, vs,
                                             fused_dequant=fused)
    torch.cuda.synchronize()
    assert pa.PAGED_ROUTE_STATS == _counts(cuda_stats_int8=1)
    ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(
        q.float(), kq, vq, pt, rl, ok, ks, vs)
    _check_stats(o, lse, ref_o, ref_lse, rl, ok, dtype)


@pytest.mark.parametrize("Qb", [8, 64], ids=["warp-form", "prefill-form"])
@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "unfused"])
def test_int8_stats_kernel_nan_scale_reaches_exactly_its_readers(fused, Qb):
    """A NaN K scale on an owned page reaches exactly the rows that read
    it (not the rows of its lane that stop before it); one on a page this
    shard does not own reaches nobody."""
    q, kq, vq, pt, rl, ks, vs = _int8(_case(3, 5, Qb, 12, 64, 16, 8,
                                            torch.float32))
    ok = _page_ok(pt, owner_none=0)
    # lane 3 (107 positions): the warp form's rows all read its third
    # page; the prefill form's staircase (rows of 44..107 positions)
    # holds rows on both sides of its fifth
    e = 2 if Qb == 8 else 4
    ks[int(pt[3, e]), 5] = float("nan")        # owned
    ks[int(pt[3, e - 1]), 6] = float("nan")    # not owned
    o, lse = pa.ragged_paged_attention_stats(q, kq, vq, pt, rl, ok, ks, vs,
                                             fused_dequant=fused)
    ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(q, kq, vq, pt, rl,
                                                         ok, ks, vs)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(o).all(dim=-1)                    # [G, Qb, H]
    want = ~torch.isfinite(ref_o).all(dim=-1)
    assert want.any() and torch.equal(bad, want)
    # the readers: head 5 of lane 3's rows that see past the page's start
    assert torch.equal(bad[3, :, 5], rl[3] > 16 * e)
    if Qb == 64:
        assert ((rl[3] > 0) & (rl[3] <= 16 * e)).any()
    assert not bad[:, :, [h for h in range(12) if h != 5]].any()
    fin = ~want[..., None].expand_as(o)
    torch.testing.assert_close(o[fin], ref_o[fin], rtol=0, atol=1e-4)
    torch.testing.assert_close(lse[~want], ref_lse[~want], rtol=0,
                               atol=LSE_TOL)


@pytest.mark.parametrize("pattern", OWNERSHIP)
@pytest.mark.parametrize("Qb", [pa.STATS_PREFILL_ROWS - 1,
                                pa.STATS_PREFILL_ROWS, 17, 33, 64, 100])
@pytest.mark.parametrize("H,D,P,M", [(6, 64, 16, 8), (6, 48, 16, 8),
                                     (6, 128, 16, 4), (2, 256, 16, 4)],
                         ids=["gpt2-tp2", "d48", "d128", "d256"])
def test_stats_prefill_form_edges_match_plain_version(H, D, P, M, Qb,
                                                      pattern):
    """Row counts around the prefill form's threshold and past a whole
    number of 16-row blocks, at the mesh drive's 6 heads, D 48, 128 and
    256:
    f32, bf16 and int8 (both dequant placements) against the plain
    version."""
    q, kp, vp, pt, rl = _case(6, 5, Qb, H, D, P, M, torch.float32)
    ok = _page_ok(pt, pattern=pattern)
    for dtype in (torch.float32, torch.bfloat16):
        args = (q.to(dtype), kp.to(dtype), vp.to(dtype), pt, rl, ok)
        _zero_counts()
        o, lse = pa.ragged_paged_attention_stats(*args)
        torch.cuda.synchronize()
        assert pa.PAGED_ROUTE_STATS == _counts(cuda_stats=1)
        ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(
            *(a.float() if a.is_floating_point() else a for a in args))
        _check_stats(o, lse, ref_o, ref_lse, rl, ok, dtype)
    _, kq, vq, _, _, ks, vs = _int8((q, kp, vp, pt, rl))
    ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(q, kq, vq, pt, rl,
                                                         ok, ks, vs)
    for fused in (1, 0):
        _zero_counts()
        o, lse = pa.ragged_paged_attention_stats(q, kq, vq, pt, rl, ok, ks,
                                                 vs, fused_dequant=fused)
        torch.cuda.synchronize()
        assert pa.PAGED_ROUTE_STATS == _counts(cuda_stats_int8=1)
        _check_stats(o, lse, ref_o, ref_lse, rl, ok, torch.float32)


def test_stats_wrapper_rejects_what_the_kernel_does_not_take():
    q, kp, vp, pt, rl = _case(1, 4, 1, 2, 16, 4, 6, torch.float32)
    ok = _page_ok(pt, owner_none=0)
    with pytest.raises(ValueError, match="page_ok"):
        pa.ragged_paged_attention_stats(q, kp, vp, pt, rl, ok[:, :2])
    with pytest.raises(ValueError, match="page_ok is on cpu"):
        pa.ragged_paged_attention_stats(q, kp, vp, pt, rl, ok.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        pa.ragged_paged_attention_stats_cuda(q.cpu(), kp.cpu(), vp.cpu(),
                                             pt.cpu(), rl.cpu(), ok.cpu())
    with pytest.raises(ValueError, match="head_dim 257 > 256"):
        big = torch.zeros(4, 1, 1, 257, device="cuda")
        pools = torch.zeros(8, 4, 1, 257, device="cuda")
        pa.ragged_paged_attention_stats(big, pools, pools, pt, rl, ok)
    wide = torch.zeros(4, pa.STATS_MAX_PAGES + 1, dtype=torch.int32,
                       device="cuda")
    with pytest.raises(ValueError, match="pages_per_seq"):
        pa.ragged_paged_attention_stats(q, kp, vp, wide, rl, wide)


def test_stats_merge_over_page_shards_equals_the_full_softmax():
    """Two owners splitting every lane's pages: the lse-space merge of
    their stats equals the ragged kernel over all pages."""
    q, kp, vp, pt, rl = _case(4, 5, 8, 12, 64, 16, 8, torch.float32)
    ok = _page_ok(pt, owner_none=0)
    ok[0] = 1
    parts = [pa.ragged_paged_attention_stats(q, kp, vp, pt, rl, o)
             for o in (ok, (1 - ok).contiguous())]
    mx = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(lse - mx) for _, lse in parts]
    ctx = sum(o * wi[..., None] for (o, _), wi in zip(parts, w)) \
        / torch.clamp(w[0] + w[1], min=1e-30)[..., None]
    full = pa.ragged_paged_attention(q, kp, vp, pt, rl)
    torch.testing.assert_close(ctx, full, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"],
                         ids=["native", "int8_dynamic"])
def test_mesh_engine_streams_equal_the_single_device_engine_on_the_card(
        kv_cache_dtype):
    """tp 2 x sp 2 over 4 slots of cuda:0, in a 16-page pool (8 pages a
    sequence shard, so sequences span both): every ragged dispatch
    launches the stats kernel once per shard and layer, and the streams
    equal the single-device engine's."""
    from paddle_tpu_torch.distributed import force_device_count
    from paddle_tpu_torch.serving import create_serving_engine

    m, prompts = _engine_case()
    base = dict(page_size=4, max_batch_size=4, prefill_chunk=8, eos_id=-1,
                num_pages=16, kv_cache_dtype=kv_cache_dtype)
    single = create_serving_engine(m, **base)
    ids = [single.add_request(p, max_new_tokens=12) for p in prompts]
    outs = single.drain()
    want = [outs[r] for r in ids]
    prev = force_device_count(4)
    try:
        eng = create_serving_engine(m, mesh_axes={"tp": 2, "sp": 2}, **base)
    finally:
        force_device_count(prev)
    _zero_counts()
    ids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
    spans = set()
    while eng.scheduler.has_work() or eng._pending:
        eng.step()
        spans.update(len({p // 8 for p in eng.cache.seq_page_ids(s.seq_id)})
                     for s in eng.scheduler.running)
    outs = eng.drain()
    steps = eng.stats()["programs"]["ragged_step"]
    key = "cuda_stats_int8" if kv_cache_dtype else "cuda_stats"
    assert pa.PAGED_ROUTE_STATS == _counts(**{key: 2 * 4 * steps})
    assert eng.stats()["metrics"]["shard"]["steps"] == steps
    assert 2 in spans and eng.cache.pages_in_use == 0
    for w, rid in zip(want, ids):
        np.testing.assert_array_equal(outs[rid], w)


# --------------------------------------------------------------------------
# flash attention (bodies #5, #6, #7)
# --------------------------------------------------------------------------
def _flash_case(seed, B, H, S, D, dtype, masked):
    """Random q, k, v, dO [B, H, S, D] and a [B, S] kv mask (padded
    tails of random length when ``masked``, at least half kept)."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(B, H, S, D).astype(
        np.float32)).to("cuda", dtype) for _ in range(4))
    mask = torch.ones(B, S)
    if masked:
        for b in range(B):
            mask[b, rng.randint(max(1, S // 2), S + 1):] = 0.0
    return q, k, v, g, mask.cuda()


def _close(got, want, tol, what, rel_l2=None):
    """Max-abs error within ``tol`` × max(1, max |want|), and, where
    ``rel_l2`` is given, the whole tensor's relative L2 error within it."""
    want = want.float()
    err = float((got.float() - want).abs().max())
    limit = tol * max(1.0, float(want.abs().max()))
    assert err <= limit, f"{what}: max_abs_err {err} > {limit}"
    if rel_l2 is not None:
        rel = chip_smoke.flash_rel_l2(got, want)
        assert rel <= rel_l2, f"{what}: relative L2 {rel} > {rel_l2}"


@pytest.mark.parametrize("variant", ["plain", "mask_dropout"])
@pytest.mark.parametrize("D", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("S", [1, 100, 1000, 1024])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_flash_kernels_match_plain_versions(dtype, causal, S, D, variant):
    B, H = 2, 3
    masked = variant == "mask_dropout"
    p, seed = (0.1, -77) if masked else (0.0, 0)
    q, k, v, g, mask = _flash_case(S + D, B, H, S, D, dtype, masked)
    scale = 1.0 / np.sqrt(D)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    ref_o, ref_lse = fa.flash_fwd_ref(qf, kf, vf, mask, seed, scale, causal,
                                      p)
    delta = (gf * ref_o).sum(-1).reshape(B * H, S, 1)
    fa.FLASH_ROUTE_STATS.update(fwd=0, dkv=0, dq=0, ref=0)
    o, lse = fa._flash_fwd_bhsd(q, k, v, mask, seed, scale, causal, p)
    dk, dv = fa._flash_dkv_bhsd(q, k, v, g, ref_lse, delta, mask, seed,
                                scale, causal, p)
    dq = fa._flash_dq_bhsd(q, k, v, g, ref_lse, delta, mask, seed, scale,
                           causal, p)
    torch.cuda.synchronize()
    assert fa.FLASH_ROUTE_STATS == {"fwd": 1, "dkv": 1, "dq": 1, "ref": 0}
    rdk, rdv = fa.flash_dkv_ref(qf, kf, vf, gf, ref_lse, delta, mask, seed,
                                scale, causal, p)
    rdq = fa.flash_dq_ref(qf, kf, vf, gf, ref_lse, delta, mask, seed, scale,
                          causal, p)
    tol = TOL[dtype]
    for name, got, want in (("o", o, ref_o), ("dk", dk, rdk),
                            ("dv", dv, rdv), ("dq", dq, rdq)):
        assert got.dtype == dtype and got.shape == q.shape, name
        _close(got, want, tol, name, chip_smoke.FLASH_REL_L2.get(dtype))
    assert lse.dtype == torch.float32 and lse.shape == (B * H, S, 1)
    _close(lse, ref_lse, 1e-4, "lse")


@pytest.mark.parametrize("seed", [0, 123456789, -2 ** 31])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_flash_kernels_regenerate_the_keep_mask_bit_for_bit(seed, p):
    B, H, S, D = 2, 3, 200, 64
    mask = torch.ones(B, S, device="cuda")
    mask[1, 150:] = 0.0
    bits = chip_smoke.flash_keep_bits(mask, H, S, D, seed, p)
    want = chip_smoke.flash_keep_reference(mask, H, S, seed, p)
    assert 0 < int(want.sum()) < want.numel()
    for name, got in bits.items():
        assert torch.equal(got, want), name


def test_bf16_flash_kernels_regenerate_the_keep_mask_bit_for_bit():
    """The bf16 bodies (all three on the tensor cores) apply exactly
    ``_keep_mask``'s bits."""
    B, H, S, D = 2, 3, 200, 64
    mask = torch.ones(B, S, device="cuda")
    mask[1, 150:] = 0.0
    for seed, p in ((0, 0.1), (-2 ** 31, 0.5)):
        bits = chip_smoke.flash_keep_bits(mask, H, S, D, seed, p,
                                          torch.bfloat16)
        want = chip_smoke.flash_keep_reference(mask, H, S, seed, p)
        for name, got in bits.items():
            assert torch.equal(got, want), (name, seed, p)


def _flash_all(q, k, v, g, mask, seed, scale, causal, p, lse, delta):
    o, lse_out = fa._flash_fwd_bhsd(q, k, v, mask, seed, scale, causal, p)
    dk, dv = fa._flash_dkv_bhsd(q, k, v, g, lse, delta, mask, seed, scale,
                                causal, p)
    dq = fa._flash_dq_bhsd(q, k, v, g, lse, delta, mask, seed, scale,
                           causal, p)
    return o, lse_out, dk, dv, dq


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("Sq,Sk,D,causal",
                         [(1000, 1000, 100, True), (333, 1000, 100, False),
                          (300, 700, 64, False), (700, 300, 64, True),
                          (500, 260, 80, False), (257, 129, 30, True)],
                         ids=["d100", "d100_sq333_sk1000",
                              "sq300_sk700", "sq700_sk300_causal",
                              "d80_sq500_sk260", "d30_sq257_sk129_causal"])
def test_flash_kernels_unaligned_rows_and_unequal_lengths(Sq, Sk, D, causal,
                                                          dtype):
    """Rows of D = 100 bf16 (not a multiple of 16 bytes: loaded element by
    element), rows of D = 30 (not a multiple of 4 floats either) and
    Sq != Sk (as ring attention calls the bodies) against the plain
    versions, with a padded kv mask and dropout."""
    B, H, p, seed = 2, 3, 0.1, 31
    rng = np.random.RandomState(Sq + Sk + D)
    q, g = (torch.from_numpy(rng.randn(B, H, Sq, D).astype(np.float32))
            .to("cuda", dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(B, H, Sk, D).astype(np.float32))
            .to("cuda", dtype) for _ in range(2))
    mask = torch.ones(B, Sk, device="cuda")
    mask[1, Sk - Sk // 3:] = 0.0
    scale = 1.0 / np.sqrt(D)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    ref_o, ref_lse = fa.flash_fwd_ref(qf, kf, vf, mask, seed, scale, causal,
                                      p)
    delta = (gf * ref_o).sum(-1).reshape(B * H, Sq, 1)
    o, lse, dk, dv, dq = _flash_all(q, k, v, g, mask, seed, scale, causal,
                                    p, ref_lse, delta)
    torch.cuda.synchronize()
    rdk, rdv = fa.flash_dkv_ref(qf, kf, vf, gf, ref_lse, delta, mask, seed,
                                scale, causal, p)
    rdq = fa.flash_dq_ref(qf, kf, vf, gf, ref_lse, delta, mask, seed, scale,
                          causal, p)
    for name, got, want in (("o", o, ref_o), ("dk", dk, rdk),
                            ("dv", dv, rdv), ("dq", dq, rdq)):
        assert got.dtype == dtype and got.shape == want.shape, name
        _close(got, want, TOL[dtype], name,
               chip_smoke.FLASH_REL_L2.get(dtype))
    _close(lse, ref_lse, 1e-4, "lse")


@pytest.mark.parametrize("p,dtype", [
    pytest.param(0.0, torch.bfloat16, id="0.0"),
    pytest.param(0.1, torch.bfloat16, id="0.1"),
    pytest.param(0.0, torch.float32, id="f32-0.0"),
    pytest.param(0.1, torch.float32, id="f32-0.1"),
    pytest.param(0.1, torch.float16, id="f16-0.1")])
def test_bf16_flash_kernels_are_deterministic(p, dtype):
    """Two launches of each bf16 body on the same inputs give the same
    bits (no atomics, a fixed order of sums); so do the f32 bodies (the
    f32 dK/dV and dQ on the tensor cores in 3xTF32)."""
    B, H, S, D = 2, 4, 1000, 64
    q, k, v, g, mask = _flash_case(11, B, H, S, D, dtype, True)
    scale = 0.125
    ref_o, lse = fa.flash_fwd_ref(q.float(), k.float(), v.float(), mask, 5,
                                  scale, True, p)
    delta = (g.float() * ref_o).sum(-1).reshape(B * H, S, 1)
    first = _flash_all(q, k, v, g, mask, 5, scale, True, p, lse, delta)
    second = _flash_all(q, k, v, g, mask, 5, scale, True, p, lse, delta)
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dk", "dv", "dq"), first, second):
        assert torch.equal(a, b), name


def test_flash_tc_stats_count_the_tensor_core_launches():
    """FLASH_TC_STATS counts one launch of each bf16 body (forward, dK/dV
    and dQ), FLASH_FP16_STATS one of each fp16 body and
    FLASH_F32TC_STATS one of each f32 body (3xTF32 on the tensor cores);
    each dtype leaves the others' counts alone, and FLASH_ROUTE_STATS
    counts every launch as before."""
    B, H, S, D = 1, 2, 128, 64
    counters = {torch.float32: fa.FLASH_F32TC_STATS,
                torch.bfloat16: fa.FLASH_TC_STATS,
                torch.float16: fa.FLASH_FP16_STATS}
    for dtype in counters:
        q, k, v, g, mask = _flash_case(3, B, H, S, D, dtype, False)
        lse = torch.zeros(B * H, S, 1, device="cuda")
        fa.FLASH_ROUTE_STATS.update(fwd=0, dkv=0, dq=0, ref=0)
        for c in counters.values():
            c.update(fwd=0, dkv=0, dq=0)
        _flash_all(q, k, v, g, mask, 0, 0.125, True, 0.0, lse, lse)
        torch.cuda.synchronize()
        assert fa.FLASH_ROUTE_STATS == {"fwd": 1, "dkv": 1, "dq": 1,
                                        "ref": 0}
        for other, c in counters.items():
            n = int(other == dtype)
            assert c == {"fwd": n, "dkv": n, "dq": n}, (dtype, other)


def test_flash_autograd_on_the_card_matches_the_plain_route():
    """FlashAttentionCore through the kernels (one launch of each) against
    the same function on the CPU's plain route, values and gradients."""
    rng = np.random.RandomState(5)
    B, S, H, D = 2, 300, 4, 64
    x = [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]
    kv_mask = np.ones((B, S), np.float32)
    kv_mask[0, 250:] = 0.0

    def run(device):
        q, k, v = (torch.tensor(a, device=device, requires_grad=True)
                   for a in x[:3])
        out = fa.flash_attention_bshd(
            q, k, v, causal=True, kv_mask=torch.tensor(kv_mask,
                                                       device=device),
            dropout_p=0.2, seed=99)
        (out * torch.tensor(x[3], device=device)).sum().backward()
        return [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]

    fa.FLASH_ROUTE_STATS.update(fwd=0, dkv=0, dq=0, ref=0)
    got = run("cuda")
    torch.cuda.synchronize()
    assert fa.FLASH_ROUTE_STATS == {"fwd": 1, "dkv": 1, "dq": 1, "ref": 0}
    want = run("cpu")
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        _close(a, b, 1e-4, name)


@pytest.mark.parametrize("seed", [99, -5])
def test_flash_seed_read_on_the_card_equals_the_seed_argument(seed):
    """An int32 seed tensor on the card (which the kernels read there,
    as a CUDA graph needs) gives the bits of the same seed passed as an
    int, values and gradients, bf16 and f32."""
    rng = np.random.RandomState(9)
    x = [rng.randn(2, 256, 4, 64).astype(np.float32) for _ in range(4)]
    for dtype in (torch.float32, torch.bfloat16):
        runs = []
        for s in (seed, torch.tensor([seed], dtype=torch.int32,
                                     device="cuda")):
            q, k, v = (torch.tensor(a, device="cuda", dtype=dtype,
                                    requires_grad=True) for a in x[:3])
            out = fa.flash_attention_bshd(q, k, v, causal=True,
                                          dropout_p=0.3, seed=s)
            (out.float() * torch.tensor(x[3], device="cuda")).sum() \
                .backward()
            runs.append([t.detach() for t in (out, q.grad, k.grad, v.grad)])
        for name, a, b in zip(("out", "dq", "dk", "dv"), *runs):
            assert torch.equal(a, b), f"{dtype} {name}"


def test_flash_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 8, 16, device="cuda")
    mask = torch.ones(1, 8, device="cuda")
    lse = torch.zeros(2, 8, 1, device="cuda")
    args = (0, 0.25, False, 0.0)
    strided = torch.zeros(1, 2, 8, 32, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd_cuda(strided, q, q, mask, *args)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(1, 2, 8, 260, device="cuda")
        fa.flash_fwd_cuda(big, big, big, mask, *args)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        h = q.double()
        fa.flash_fwd_cuda(h, h, h, mask, *args)
    with pytest.raises(ValueError, match="mask"):
        fa.flash_fwd_cuda(q, q, q, mask[:, :4].contiguous(), *args)
    with pytest.raises(ValueError, match="is on cpu"):
        fa.flash_fwd_cuda(q, q, q, mask.cpu(), *args)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_dq_cuda(q, q, q, q, lse[:1], lse, mask, *args)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_dkv_cuda(q, q, q, q.bfloat16(), lse, lse, mask, *args)
    with pytest.raises(ValueError, match="CUDA"):
        c = q.cpu()
        fa.flash_fwd_cuda(c, c, c, mask.cpu(), *args)


def test_training_step_on_the_card_equals_the_cpu_step():
    """A 2-layer GPT step through the flash kernels on the card: loss,
    every gradient and the weights after one AdamW step against the same
    step on the CPU's plain flash route (chip_smoke's train_parity phase
    at a small width; it raises on any difference past its tolerances)."""
    cfg = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
               ffn_size=256, max_seq_len=256)
    res = chip_smoke.train_parity_phase(np.random.RandomState(3), cfg=cfg,
                                        batch=2, seq=256)
    assert res["card_counts"]["flash_fwd"] == 2
    assert res["card_counts"]["flash_f32tc_fwd"] == 2
    assert res["card_counts"]["flash_f32tc_dkv"] == 2
    assert res["card_counts"]["flash_f32tc_dq"] == 2
    assert res["cpu_counts"]["flash_ref"] == 6


def test_autocast_training_step_on_the_card_equals_the_cpu_step():
    """The same 2-layer step with the forward under
    ``amp.auto_cast(dtype="bfloat16")``: loss and gradients against the
    CPU's plain route at bf16 tolerances, the card's AdamW step against
    the same step on the CPU from the card's gradients (chip_smoke's
    train_parity_bf16 phase at a small width; it raises past its
    tolerances), with the three flash bodies on the tensor cores."""
    cfg = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
               ffn_size=256, max_seq_len=256)
    res = chip_smoke.train_parity_bf16_phase(np.random.RandomState(3),
                                             cfg=cfg, batch=2, seq=256)
    assert res["card_counts"]["flash_tc_fwd"] == 2
    assert res["card_counts"]["flash_tc_dkv"] == 2
    assert res["card_counts"]["flash_tc_dq"] == 2
    assert res["cpu_counts"]["flash_ref"] == 6


# --------------------------------------------------------------------------
# the scale-shift kernel (row t) and the dygraph core on the card
# --------------------------------------------------------------------------
def _scale_shift_args(x_shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(x_shape, generator=g, device="cuda").to(dtype)
    return (x, torch.tensor([1.37], device="cuda"),
            torch.tensor([-0.21], device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 1_000_003])
def test_scale_shift_kernel_is_bit_equal_to_plain(n, dtype):
    x, s, b = _scale_shift_args((n,), dtype)
    ss.SCALE_SHIFT_ROUTE_STATS.update(cuda=0, ref=0)
    got = ss.scale_shift(x, s, b)
    torch.cuda.synchronize()
    assert ss.SCALE_SHIFT_ROUTE_STATS == {"cuda": int(n > 0), "ref": 0}
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, ss.scale_shift_ref(x, s, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_scale_shift_kernel_on_views(dtype):
    """A transposed (non-contiguous) x and a view one element into its
    storage (not 16-byte aligned: the scalar path), 0-d scale/shift."""
    x, s, b = _scale_shift_args((33, 64), dtype, seed=1)
    for view in (x.t(), x.reshape(-1)[1:], x[:, 1:]):
        assert view.data_ptr() % 16 or not view.is_contiguous()
        got = ss.scale_shift_cuda(view, s.reshape(()), b.reshape(()))
        assert got.shape == view.shape
        assert torch.equal(got, ss.scale_shift_ref(view, s, b))


def test_scale_shift_kernel_needs_no_host_sync():
    x, s, b = _scale_shift_args((16, 8), torch.float32)
    ss.scale_shift_cuda(x, s, b)            # built and bound
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ss.scale_shift(x, s, b)
        grads = ss.scale_shift_vjp(out, x, s, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out, ss.scale_shift_ref(x, s, b))
    assert [tuple(g.shape) for g in grads] == [(16, 8), (1,), (1,)]


def test_scale_shift_kernel_rejects_what_it_does_not_take():
    x, s, b = _scale_shift_args((4, 8), torch.float32)
    with pytest.raises(ValueError, match="float32, bfloat16"):
        ss.scale_shift_cuda(x.to(torch.int32), s, b)
    with pytest.raises(ValueError, match="float32, bfloat16"):
        ss.scale_shift_cuda(x.double(), s, b)
    with pytest.raises(ValueError, match="one element"):
        ss.scale_shift_cuda(x, torch.ones(2, device="cuda"), b)
    with pytest.raises(ValueError, match="is on cpu"):
        ss.scale_shift_cuda(x, s.cpu(), b)


def test_custom_op_net_on_the_card_equals_the_cpu():
    """chip_smoke's custom_op phase: 15 Adam steps of the custom-op net,
    30 kernel launches and no plain call, losses equal to the CPU's."""
    res = chip_smoke.custom_op_phase()
    assert res["scale_shift_launches"] == {"cuda": 30, "ref": 0}


def test_lenet_on_the_card_equals_the_cpu():
    res = chip_smoke.lenet_phase()
    assert res["max_rel_diff_vs_cpu"] <= chip_smoke.TRAIN_CPU_RTOL


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"],
                         ids=["native", "int8_dynamic"])
@pytest.mark.parametrize("mesh_axes", [{"sp": 2}, {"tp": 2, "sp": 2}],
                         ids=["sp2", "tp2sp2"])
def test_quarantine_at_sp_fails_only_the_victim_on_the_card(mesh_axes,
                                                            kv_cache_dtype):
    """tests/test_torch_mesh_serving.py's F1 drive on the card: a 2-layer
    GPT (seed 0), page 4, 12 pages, sync mode, requests of 9 and 6
    tokens; the second is poisoned after 7 steps, when both span both
    page shards.  Exactly the victim fails; the survivor's stream equals
    the single-device engine's."""
    from paddle_tpu_torch.distributed import force_device_count
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.models import GPTModel

    m = GPTModel(vocab_size=50, hidden_size=32, num_layers=2, num_heads=2,
                 ffn_size=64, max_seq_len=64, device="cuda", seed=0)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 50, (n,)).astype(np.int32) for n in (9, 6)]

    def drive(axes):
        eng = ServingEngine(m, mesh_axes=axes, page_size=4,
                            max_batch_size=4, prefill_chunk=4, eos_id=-1,
                            sync_mode=True, num_pages=12,
                            kv_cache_dtype=kv_cache_dtype)
        ids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
        for _ in range(7):
            eng.step()
        victim = next(s for s in eng.scheduler.running
                      if s.seq_id == ids[1])
        eng._poison_lane(victim)
        outs = eng.drain()
        assert eng.take_faulted() == [ids[1]] and ids[1] not in outs
        assert eng.cache.pages_in_use == 0
        return outs[ids[0]]

    want = drive(None)
    prev = force_device_count(4)
    try:
        got = drive(mesh_axes)
    finally:
        force_device_count(prev)
    assert len(got) == 10
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the serving programs as CUDA graphs (profiler/jit_cost.py)
# --------------------------------------------------------------------------
# the arms: engine knobs; "export" is replaced by an int8 export
GRAPH_ARMS = {
    "native": {},
    "int8_static": dict(kv_cache_dtype="int8", weight_dtype="int8",
                        quant_scales="export"),
    "int8_dynamic": dict(kv_cache_dtype="int8", weight_dtype="int8"),
    "split": dict(ragged=False),
    "fused4": dict(fused_steps=4),
    "mesh": dict(mesh_axes={"tp": 2, "sp": 2}, num_pages=16),
}
SYNC_FREE_ARMS = ("native", "int8_static", "int8_dynamic", "mesh")


def _graph_engine(m, arm, export=None, **extra):
    """The small card engine of ``arm``; a mesh's 4 slots on cuda:0."""
    from paddle_tpu_torch.distributed import force_device_count
    from paddle_tpu_torch.serving import create_serving_engine

    knobs = dict(page_size=4, max_batch_size=4, prefill_chunk=8, eos_id=-1)
    knobs.update(GRAPH_ARMS[arm], **extra)
    if knobs.get("quant_scales") == "export":
        knobs["quant_scales"] = export
    prev = force_device_count(4 if "mesh_axes" in knobs else None)
    try:
        return create_serving_engine(m, **knobs)
    finally:
        force_device_count(prev)


def _export(m):
    from paddle_tpu_torch.slim import export_serving_quant

    return export_serving_quant(m, calib_prompts=np.random.RandomState(
        3).randint(1, 64, (4, 24)))


def _forwards(eng):
    """Attention launches a layer: ragged steps (4 shards on the mesh) or
    the split programs' forwards."""
    calls = eng.stats()["programs"]
    if eng.ragged:
        return calls["ragged_step"] * (4 if eng._mesh_layout else 1)
    return (calls["decode"] + calls["prefill"] + calls["spec_verify"]
            + eng.fused_steps * calls["decode_fused"])


@pytest.mark.parametrize("arm", list(GRAPH_ARMS))
def test_graphed_streams_equal_eager_and_generate(arm):
    """Each arm served twice, eager under ``disable_jit()`` and graphed:
    the same launches a forward on the arm's kernel in both (a replay
    adds its captured launches), replays in the graphed drive only,
    streams equal to each other and to ``generate`` (int8_static:
    ``generate(quant=...)``; int8_dynamic has no dense twin)."""
    from contextlib import nullcontext

    from paddle_tpu_torch.profiler.jit_cost import (cost_registry,
                                                    disable_jit)
    from paddle_tpu_torch.text.generation import generate

    m, prompts = _engine_case()
    export = _export(m) if arm == "int8_static" else None
    streams = {}
    for mode in ("eager", "graphed"):
        eng = _graph_engine(m, arm, export)
        assert eng.stats()["pipeline"]["cuda_graphs"]
        _zero_counts()
        qm.QMM_ROUTE_STATS.update(cuda=0, ref=0)
        before = cost_registry.snapshot()
        with disable_jit() if mode == "eager" else nullcontext():
            ids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
            outs = eng.drain()
        costs = chip_smoke.jit_delta(before)
        n = 2 * _forwards(eng)
        int8 = "kv_cache_dtype" in GRAPH_ARMS[arm]
        key = ("cuda_stats" if arm == "mesh" else "cuda" if eng.ragged
               else "cuda_decode") + ("_int8" if int8 else "")
        assert pa.PAGED_ROUTE_STATS == _counts(**{key: n})
        assert qm.QMM_ROUTE_STATS == {"cuda": 6 * n if int8 else 0, "ref": 0}
        replays = sum(c["replays"] for c in costs.values())
        assert (replays > 0) == (mode == "graphed"), costs
        assert eng.cache.pages_in_use == 0
        streams[mode] = [outs[r] for r in ids]
    for a, b in zip(streams["eager"], streams["graphed"]):
        np.testing.assert_array_equal(a, b)
    if arm != "int8_dynamic":
        for p, got in zip(prompts, streams["graphed"]):
            want = generate(m, p[None], max_new_tokens=12, end_id=-1,
                            quant=export)[0][0].cpu().numpy()
            np.testing.assert_array_equal(got, want)


def _pools_copy(kv):
    return {side: [t.clone() for t in ts] for side, ts in kv.items()}


def _pools_put(kv, saved):
    for side, ts in kv.items():
        for t, s in zip(ts, saved[side]):
            t.copy_(s)


@pytest.mark.parametrize("arm", ["native", "int8_static"])
def test_graphed_ragged_step_is_bit_equal_to_the_eager_step(arm):
    """The same inputs and pools through the ragged step's replay and
    through the eager function: out_rows and every pool byte equal."""
    from paddle_tpu_torch.profiler.jit_cost import (cost_registry,
                                                    disable_jit)

    m, prompts = _engine_case()
    eng = _graph_engine(m, arm, _export(m) if arm == "int8_static" else None)
    for p in prompts[:4]:
        eng.add_request(p, max_new_tokens=12)
    for _ in range(3):
        eng.step()
    eng._sync_pending()
    B = eng._state_bucket
    args = (eng._tokens.clone(), eng._pos.clone(), eng._tables.clone(),
            *eng._steady_rows(B))
    start = _pools_copy(eng._kv)
    eng._ragged_fn(*args, eng._kv)         # captured (or replayed)
    _pools_put(eng._kv, start)
    before = cost_registry.snapshot()
    graphed = [t.clone() for t in eng._ragged_fn(*args, eng._kv)[:4]]
    assert chip_smoke.jit_delta(before)["serving.ragged_step"][
        "replays"] == 1
    after_graph = _pools_copy(eng._kv)
    _pools_put(eng._kv, start)
    with disable_jit():
        eager = eng._ragged_fn(*args, eng._kv)[:4]
    for g, e in zip(graphed, eager):
        assert torch.equal(g, e)
    for side, ts in after_graph.items():
        for g, e in zip(ts, eng._kv[side]):
            assert torch.equal(g, e), side


def test_graph_captures_once_per_bucket_and_never_in_steady_decode():
    """Zero captures over 32 steady steps (each a replay, L launches of
    #1 each), exactly one capture when the lane bucket grows."""
    from paddle_tpu_torch.profiler.jit_cost import (compile_budget,
                                                    cost_registry)

    m, prompts = _engine_case()
    eng = _graph_engine(m, "native", max_batch_size=2)
    eng.add_request(prompts[3], max_new_tokens=60, request_id="a")
    for _ in range(6):
        eng.step()                          # bucket 1 decoding
    assert eng._state_bucket == 1
    with compile_budget(None, names=("serving.ragged_step",)) as cb:
        eng.add_request(prompts[1][:2], max_new_tokens=60, request_id="b")
        for _ in range(4):
            eng.step()                      # admit -> bucket 2
        assert eng._state_bucket == 2
    assert cb.compiles() == {"serving.ragged_step": 1}
    eng.step()
    _zero_counts()
    before = cost_registry.snapshot()
    with compile_budget(0, prefix="serving."):
        for _ in range(32):
            assert eng.step()["bucket"] == 2
    costs = chip_smoke.jit_delta(before)["serving.ragged_step"]
    assert costs["replays"] == 32 and costs["captures"] == 0
    assert pa.PAGED_ROUTE_STATS == _counts(cuda=2 * 32)
    assert eng.stats()["jit_costs"]["serving.ragged_step"]["graphed"]
    eng.drain()


@pytest.mark.parametrize("arm", SYNC_FREE_ARMS)
def test_steady_decode_is_sync_free(arm):
    """chip_smoke's sync_free window on the small engines: 32 steady
    steps under ``set_sync_debug_mode("error")`` and a compile budget of
    0, one replay a step."""
    m, prompts = _engine_case()
    # a pool that holds the four lanes' 48 new tokens (no preemption)
    eng = _graph_engine(m, arm, _export(m) if arm == "int8_static" else None,
                        num_pages=80)
    res = chip_smoke.sync_free_window(eng, prompts[1:5], budget=48)
    assert res["programs"]["serving.ragged_step"]["replays"] == 32


def test_a_replaced_pool_raises_on_the_card():
    from paddle_tpu_torch.framework.errors import InvalidArgumentError

    m, prompts = _engine_case()
    eng = _graph_engine(m, "native")
    eng.add_request(prompts[2], max_new_tokens=12)
    for _ in range(4):
        eng.step()
    eng._kv["v"][0] = eng._kv["v"][0].clone()
    with pytest.raises(InvalidArgumentError, match="donated tensor leaf"):
        eng.step()


def test_a_failed_capture_raises():
    """A function that reads a device value on the host cannot be
    captured: the runner raises (after the eager warm-up ran), and the
    next call of the signature raises again — nothing falls back."""
    from paddle_tpu_torch.profiler.jit_cost import profiled_graph

    f = profiled_graph("test.sync_in_capture",
                       lambda x: x * float(x.sum().item()))
    x = torch.ones(4, device="cuda")
    for _ in range(2):
        with pytest.raises(RuntimeError):
            f(x)
    torch.cuda.synchronize()
    assert torch.equal(x + 1, torch.full((4,), 2.0, device="cuda"))


# --------------------------------------------------------------------------
# the prefix cache and snapshots on the card: prefill chunks that start at
# a cached page boundary, streams, in-place pool writes and the
# shared-prefix sync-free window
# --------------------------------------------------------------------------
BOUNDARY_START = 528          # 33 pages of 16: a page boundary, not a
BOUNDARY_ROWS = 64            # multiple of the 64-row chunk


def _boundary_case(D, dtype, P=16, M=48):
    """Lane 0: a prefill chunk of BOUNDARY_ROWS rows starting at
    BOUNDARY_START (the first chunk of a prefix-hit lane), row r seeing
    BOUNDARY_START + r + 1 positions; lane 1: one decode row over 700
    positions (its other rows empty).  Pages distinct and random, random
    content in the trash page 0."""
    H = 12 if D == 64 else 4
    rng = np.random.RandomState(D)
    G, Qb = 2, BOUNDARY_ROWS
    N = 1 + G * M
    perm = rng.permutation(np.arange(1, N))
    pt = np.zeros((G, M), np.int32)
    lens = (BOUNDARY_START + Qb, 700)
    for g, n in enumerate(lens):
        pt[g, :-(-n // P)] = perm[g * M:g * M + -(-n // P)]
    rl = np.zeros((G, Qb), np.int32)
    rl[0] = BOUNDARY_START + 1 + np.arange(Qb)
    rl[1, 0] = lens[1]
    q, kp, vp = (torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
                 for a in (rng.randn(G, Qb, H, D), rng.randn(N, P, H, D),
                           rng.randn(N, P, H, D)))
    return q, kp, vp, torch.from_numpy(pt).cuda(), torch.from_numpy(rl).cuda()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("D", [64, 256])
def test_ragged_chunk_at_an_unaligned_page_boundary(D, quant):
    """#1 / #1q: the prefill form over a chunk starting at position 528
    beside a decode lane, against the plain version."""
    args = _boundary_case(D, torch.float32)
    _zero_counts()
    _check_ragged(_int8(args) if quant else args)
    assert pa.PAGED_ROUTE_STATS == _counts(
        **{"cuda_int8" if quant else "cuda": 1})


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("D", [64, 256])
def test_decode_chunk_at_an_unaligned_page_boundary(D, quant):
    """#2 / #2q: the split prefill's chunk starting at position 528 (64
    rows of one sequence sharing its table row), against the plain
    version."""
    q, kp, vp, pt, rl = _boundary_case(D, torch.float32)
    args = (q[0].contiguous(), kp, vp,
            pt[0:1].repeat(BOUNDARY_ROWS, 1).contiguous(),
            rl[0].contiguous())
    _zero_counts()
    if quant:
        _, kq, vq, _, _, ks, vs = _int8((q, kp, vp, pt, rl))
        out = pa.paged_attention(args[0], kq, vq, args[3], args[4], ks, vs)
        ref = pa.paged_attention_ref(args[0], kq, vq, args[3], args[4], ks,
                                     vs)
    else:
        out = pa.paged_attention(*args)
        ref = pa.paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert pa.PAGED_ROUTE_STATS == _counts(
        **{"cuda_decode_int8" if quant else "cuda_decode": 1})
    torch.testing.assert_close(out.float(), ref, rtol=0,
                               atol=TOL[torch.float32])


def _prefix_prompts(vocab=64):
    """A donor whose prompt is a 16-token system prompt (4 pages of 4),
    then three readers: the same prompt (a full-prompt hit: a copy), and
    two with their own suffixes."""
    rng = np.random.RandomState(21)
    system = rng.randint(1, vocab, (16,)).astype(np.int32)
    return system, [system.copy()] + [
        np.concatenate([system, rng.randint(1, vocab, (n,)).astype(
            np.int32)]) for n in (3, 9)]


def _prefix_drive(eng, donor, readers):
    rid = eng.add_request(donor, max_new_tokens=12)
    outs = eng.drain()
    ids = [eng.add_request(p, max_new_tokens=12) for p in readers]
    outs.update(eng.drain())
    return [outs[r] for r in [rid] + ids]


@pytest.mark.parametrize("arm", ["native", "int8_static", "split"])
def test_prefix_engine_streams_on_the_card(arm):
    """``prefix_cache=True`` on the card: the readers hit the donor's
    pages (one copy-on-write), every launch on the arm's kernel, streams
    equal to the cache-off engine's and to ``generate`` (int8_static:
    ``generate(quant=...)``), the leak invariant after the drain."""
    from paddle_tpu_torch.text.generation import generate

    m, _ = _engine_case()
    export = _export(m) if arm == "int8_static" else None
    donor, readers = _prefix_prompts()
    streams = {}
    for pc in (False, True):
        eng = _graph_engine(m, arm, export, prefix_cache=pc)
        _zero_counts()
        streams[pc] = _prefix_drive(eng, donor, readers)
        n = 2 * _forwards(eng)
        int8 = arm == "int8_static"
        key = ("cuda" if eng.ragged else "cuda_decode") + (
            "_int8" if int8 else "")
        assert pa.PAGED_ROUTE_STATS == _counts(**{key: n})
        c = eng.cache
        assert c.pages_in_use == 0
        assert c.pages_in_use + c.pages_cached + c.free_pages == \
            c.allocatable_pages
    st = eng.stats()["prefix_cache"]
    assert st["hits"] == 3 and st["cow_copies"] == 1
    for a, b in zip(streams[True], streams[False]):
        np.testing.assert_array_equal(a, b)
    for p, got in zip([donor] + readers, streams[True]):
        want = generate(m, p[None], max_new_tokens=12, end_id=-1,
                        quant=export)[0][0].cpu().numpy()
        np.testing.assert_array_equal(got, want)


def test_cow_and_restore_write_the_pools_in_place():
    """The copy-on-write and a snapshot's upload write the pools in
    place: every pool tensor keeps its ``data_ptr`` across admission, the
    copy and the restore, and the graphed ragged step keeps replaying."""
    m, _ = _engine_case()
    donor, readers = _prefix_prompts()
    eng = _graph_engine(m, "native", prefix_cache=True)
    ptrs = chip_smoke.pool_ptrs(eng)
    _prefix_drive(eng, donor, readers[:1])
    assert eng.stats()["prefix_cache"]["cow_copies"] == 1
    assert chip_smoke.pool_ptrs(eng) == ptrs
    rid = eng.add_request(readers[2], max_new_tokens=12)
    for _ in range(64):
        eng.step()
        seq = next((s for s in eng.scheduler.running if s.seq_id == rid),
                   None)
        if seq is not None and len(seq.generated) >= 4:
            break
    snap = eng.snapshot(rid)
    assert snap is not None
    surv = _graph_engine(m, "native")
    sptrs = chip_smoke.pool_ptrs(surv)
    want = eng.drain()[rid]
    surv.restore(snap)
    got = surv.drain()[rid]
    assert chip_smoke.pool_ptrs(surv) == sptrs
    assert chip_smoke.pool_ptrs(eng) == ptrs
    assert surv.stats()["jit_costs"]["serving.ragged_step"]["replays"] > 0
    np.testing.assert_array_equal(got, want)


def test_shared_prefix_window_is_sync_free():
    """chip_smoke's shared-prefix window on the small engine: after the
    admission's copy-on-write and write barrier, 32 steady steps under
    ``set_sync_debug_mode("error")`` and a compile budget of 0."""
    m, _ = _engine_case()
    eng = _graph_engine(m, "native", prefix_cache=True, num_pages=80)
    donor, lanes = chip_smoke.prefix_window_prompts(
        np.random.RandomState(9), 64, system_len=16, suffix_len=3)
    res = chip_smoke.prefix_sync_free_window(eng, donor, lanes)
    assert res["programs"]["serving.ragged_step"]["replays"] == 32
    assert res["prefix_cache"]["cow_copies"] == 1


# --------------------------------------------------------------------------
# the host and disk KV page tiers (serving/kv_transport.py) on the card
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tier_round_trip_is_bit_exact_on_the_card(dtype):
    """A page demoted to the host (``_tier_gather``: f32 as is, bf16 as
    its int16 bit pattern) and written back into another page
    (``_tier_restore``: pinned upload, in-place write) equals the
    original bit for bit in every layer and side; the pools keep their
    addresses."""
    from paddle_tpu_torch.serving import create_serving_engine
    from paddle_tpu_torch.text.models import GPTModel

    m = GPTModel(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
                 ffn_size=128, max_seq_len=128, device="cuda", seed=7,
                 dtype=dtype)
    eng = create_serving_engine(m, page_size=4, max_batch_size=4,
                                eos_id=-1, prefix_cache=True,
                                kv_tiering=True)
    ptrs = chip_smoke.pool_ptrs(eng)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for side in ("k", "v"):
        for pool in eng._kv[side]:
            pool.copy_(torch.randn(pool.shape, device="cuda",
                                   generator=gen))
    (payload,) = eng._tier_gather([3])
    want = np.int16 if dtype == torch.bfloat16 else np.float32
    assert {a.dtype for arrs in payload.values() for a in arrs} == {
        np.dtype(want)}
    eng._tier_restore([5], [payload])
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for side in ("k", "v"):
        for pool in eng._kv[side]:
            assert torch.equal(pool[5].view(bits), pool[3].view(bits))
    assert chip_smoke.pool_ptrs(eng) == ptrs


@pytest.mark.parametrize("arm", ["native", "int8_static"])
def test_tiered_engine_streams_on_the_card(arm):
    """Demote a donor's pages (an opted-out flood's admission), promote
    them back (the readers' admission): streams equal to the tiers-off
    engine's and to ``generate``, every launch on the arm's kernel, the
    pools in place, the leak invariant."""
    from paddle_tpu_torch.text.generation import generate

    m, _ = _engine_case()
    export = _export(m) if arm == "int8_static" else None
    donor, readers = _prefix_prompts()
    floods = [np.random.RandomState(30 + i).randint(1, 64, (120,)).astype(
        np.int32) for i in range(3)]
    streams = {}
    for tiering in (False, True):
        eng = _graph_engine(m, arm, export, prefix_cache=True,
                            kv_tiering=tiering, num_pages=80)
        ptrs = chip_smoke.pool_ptrs(eng)
        _zero_counts()
        rid = eng.add_request(donor, max_new_tokens=12)
        outs = eng.drain()
        for p in floods:
            eng.add_request(p, max_new_tokens=2, prefix_cache=False)
        eng.drain()
        ids = [eng.add_request(p, max_new_tokens=12) for p in readers]
        outs.update(eng.drain())
        streams[tiering] = [outs[r] for r in [rid] + ids]
        key = "cuda_int8" if arm == "int8_static" else "cuda"
        assert pa.PAGED_ROUTE_STATS == _counts(**{key: 2 * _forwards(eng)})
        assert chip_smoke.pool_ptrs(eng) == ptrs
        chip_smoke.leak_invariant(f"tiers/{arm}", eng)
    tiers = eng.stats()["prefix_cache"]["tiers"]
    assert tiers["demotions"] > 0 and tiers["promotions"] > 0
    for a, b in zip(streams[True], streams[False]):
        np.testing.assert_array_equal(a, b)
    for p, got in zip([donor] + readers, streams[True]):
        want = generate(m, p[None], max_new_tokens=12, end_id=-1,
                        quant=export)[0][0].cpu().numpy()
        np.testing.assert_array_equal(got, want)


def test_tiered_steady_decode_is_sync_free():
    """chip_smoke's tier window on the small engine: after a demote /
    promote cycle, 32 steady steps under ``set_sync_debug_mode("error")``
    and a compile budget of 0, one replay a step."""
    m, _ = _engine_case()
    eng = _graph_engine(m, "native", prefix_cache=True, kv_tiering=True,
                        num_pages=80)
    donor, lanes = chip_smoke.prefix_window_prompts(
        np.random.RandomState(9), 64, system_len=16, suffix_len=3)
    floods = [np.random.RandomState(30 + i).randint(1, 64, (120,)).astype(
        np.int32) for i in range(3)]
    res = chip_smoke.tier_sync_free_window(eng, donor, lanes, floods)
    assert res["programs"]["serving.ragged_step"]["replays"] == 32
    tiers = res["prefix_cache"]["tiers"]
    assert tiers["demotions"] > 0 and tiers["promotions"] > 0


# --------------------------------------------------------------------------
# the serving front door on the card: several engines stepping from
# several threads of one process (captures under the capture gate, the
# launch counters exact), the frontend's failover and the HTTP path
# --------------------------------------------------------------------------
CAPTURE_ROUNDS = 12


def _step_to_done(eng, barrier, outs, errors, key):
    """One pump: wait at ``barrier`` with the other thread, then step
    ``eng`` to the end of its requests."""
    try:
        barrier.wait(timeout=60)
        outs[key] = eng.drain()
    except Exception as exc:  # noqa: BLE001 — reported by the test
        errors[key] = exc


def test_two_engines_capture_concurrently_from_two_threads():
    """Two engines, each driven by its own thread, release together
    (a barrier) into their first steps, so their first signatures are
    captured at the same moment; repeated with fresh engines (fresh
    graphs).  Every round: no thread raises, every stream equals the one
    engine alone gives, and the launch counters are exact — L launches
    of #1 for every dispatch of either engine, none lost to the other
    thread's capture, none counted twice."""
    import sys
    import threading

    m, prompts = _engine_case()
    L = len(m.layers)
    sets = (prompts[:3], prompts[3:])
    alone = []
    for ps in sets:
        eng = _graph_engine(m, "native")
        ids = [eng.add_request(p, max_new_tokens=12) for p in ps]
        outs = eng.drain()
        alone.append([outs[r] for r in ids])
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for rnd in range(CAPTURE_ROUNDS):
            engines = [_graph_engine(m, "native") for _ in sets]
            ids = [[eng.add_request(p, max_new_tokens=12) for p in ps]
                   for eng, ps in zip(engines, sets)]
            _zero_counts()
            barrier, outs, errors = threading.Barrier(2), {}, {}
            threads = [threading.Thread(target=_step_to_done,
                                        args=(eng, barrier, outs, errors, i))
                       for i, eng in enumerate(engines)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
            assert not any(th.is_alive() for th in threads), rnd
            assert not errors, (rnd, errors)
            torch.cuda.synchronize()
            dispatches = sum(e.stats()["programs"]["ragged_step"]
                             for e in engines)
            assert pa.PAGED_ROUTE_STATS == _counts(cuda=L * dispatches), rnd
            for i, (eng, rids, want) in enumerate(zip(engines, ids, alone)):
                assert chip_smoke.replica_programs(eng)["replays"] > 0
                got = [outs[i][r] for r in rids]
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
                assert eng.cache.pages_in_use == 0
    finally:
        sys.setswitchinterval(prev)


def _generate_all(m, prompts, n):
    from paddle_tpu_torch.text.generation import generate

    return [generate(m, p[None], max_new_tokens=n, end_id=-1)[0][0]
            .cpu().numpy() for p in prompts]


def test_frontend_two_replicas_one_injected_failure_on_the_card():
    """Two graphed replicas behind the front door, replica-0 killed
    mid-decode with snapshots every 4 tokens: every stream completes,
    equal to ``generate``; only replica-0 died, of the injection; the
    counters are exact summed over both replicas; the survivor leaks no
    page."""
    from paddle_tpu_torch.serving import ServingFrontend

    m, prompts = _engine_case()
    fe = ServingFrontend(m, replicas=2, snapshot_interval=4,
                         engine_kwargs=dict(page_size=4, max_batch_size=4,
                                            prefill_chunk=8, eos_id=-1))
    try:
        fe.inject_failure("replica-0", at_step=6)
        _zero_counts()
        handles = [fe.submit(p, max_new_tokens=12) for p in prompts]
        chip_smoke.consume(handles)
        assert [h.status for h in handles] == ["completed"] * len(prompts)
        dead = {r.id: r.dead_reason for r in fe._replicas
                if r.state == "dead"}
        assert dead == {"replica-0": "injected failure at step 6"}
        assert any(h.resumed_from is not None for h in handles)
        dispatches = sum(r.engine.stats()["programs"]["ragged_step"]
                         for r in fe._replicas)
        assert pa.PAGED_ROUTE_STATS == _counts(
            cuda=len(m.layers) * dispatches)
        chip_smoke.leak_invariant("fe", fe._replicas[1].engine)
    finally:
        fe.close()
    for h, want in zip(handles, _generate_all(m, prompts, 12)):
        np.testing.assert_array_equal(h.tokens, want)


def test_http_path_on_the_card():
    """``start_http_server`` over a graphed replica: a streamed
    ``POST /generate`` (chunked NDJSON) equal to ``generate``, then
    ``GET /healthz`` and ``GET /metrics`` (Prometheus text with the
    ``serving.*`` families)."""
    import http.client
    import json

    from paddle_tpu_torch.serving import ServingFrontend, start_http_server

    m, prompts = _engine_case()
    fe = ServingFrontend(m, replicas=1,
                         engine_kwargs=dict(page_size=4, max_batch_size=4,
                                            prefill_chunk=8, eos_id=-1))
    srv = start_http_server(fe, port=0)
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=120)
        conn.request("POST", "/generate", json.dumps(
            {"prompt": prompts[4].tolist(), "max_new_tokens": 12}))
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader("Transfer-Encoding") == "chunked"
        lines = [json.loads(ln) for ln in
                 r.read().decode().strip().split("\n")]
        toks = [ln["token"] for ln in lines if "token" in ln]
        assert lines[-1]["done"] and lines[-1]["status"] == "completed"
        assert toks == _generate_all(m, prompts[4:5], 12)[0].tolist()
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        hz = json.loads(r.read())
        assert r.status == 200 and hz["healthy_replicas"] == 1
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        text = r.read().decode()
        chip_smoke.check_ops_surface("http", hz, text)
    finally:
        srv.stop()
        fe.close()


# --- beam search and the paddle-API sequence layers -------------------------
def _small_gpt(device):
    """A 2-layer GPT with the same weights on either device (drawn on the
    CPU: the card's generator draws other values from the same seed)."""
    from paddle_tpu_torch.text.models import (GPTModel, load_numpy_state,
                                              numpy_state)

    kw = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
              ffn_size=128, max_seq_len=128)
    cpu = GPTModel(**kw, device="cpu", seed=7)
    if device == "cpu":
        return cpu
    return load_numpy_state(GPTModel(**kw, device=device), numpy_state(cpu))


@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_beam_generate_on_the_card_equals_the_cpu(alpha):
    """Beam ``generate`` on the card against the port's CPU run of the
    same model: ids and lengths equal, scores within 1e-4."""
    from paddle_tpu_torch.text.generation import generate

    prompt = np.random.RandomState(3).randint(1, 64, (3, 9)).astype(
        np.int32)
    kw = dict(max_new_tokens=12, end_id=0, decode_strategy="beam_search",
              num_beams=4, length_penalty=alpha)
    ids, scores = generate(_small_gpt("cuda"), prompt, **kw)
    want_ids, want_scores = generate(_small_gpt("cpu"), prompt, **kw)
    np.testing.assert_array_equal(ids.cpu().numpy(), want_ids.numpy())
    np.testing.assert_allclose(scores.cpu().numpy(), want_scores.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_beam_search_decode_is_sync_free(monkeypatch):
    """After a warm-up, the whole beam loop on the card runs under
    ``set_sync_debug_mode("error")``: no read-back, no host tensor."""
    from paddle_tpu_torch.nn.decode import beam_search_decode

    m = _small_gpt("cuda")
    prompts = torch.as_tensor(np.random.RandomState(4).randint(
        1, 64, (2, 8)).astype(np.int32), device="cuda")
    monkeypatch.setattr(chip_smoke, "BEAM_NEW", 10)
    step_fn, state = chip_smoke.beam_prefilled(m, prompts)
    bos = prompts[:, -1:].expand(2, 3)

    def run():
        return beam_search_decode(step_fn, chip_smoke.beam_lanes(state, 3),
                                  2, 3, 10, bos, 0, length_penalty=0.6)

    first = run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again.ids, first.ids)
    assert torch.equal(again.scores, first.scores)


def test_transformer_flash_route_matches_the_plain_route():
    """``nn.Transformer`` at S 256 on the card (encoder self-attention on
    the flash kernels, one launch a layer) against the same weights on
    the CPU's plain route."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import state_from_numpy
    from paddle_tpu_torch.ops import attention as attn

    rng = np.random.RandomState(6)
    src = rng.randn(2, 256, 64).astype(np.float32)
    tgt = rng.randn(2, 16, 64).astype(np.float32)
    pad = np.ones((2, 256), np.float32)
    pad[1, 190:] = 0.0
    try:
        outs = []
        for dev in ("cuda", "cpu"):
            pt.set_device(dev)
            pt.seed(3)
            model = nn.Transformer(64, 4, 2, 2, 128).eval()
            if dev == "cpu":
                model.set_state_dict(state_from_numpy(state, "cpu"))
            else:
                state = {k: v.numpy() for k, v in model.state_dict().items()}
            attn.ROUTE_STATS.update(pallas=0, xla=0)
            fa.FLASH_ROUTE_STATS.update(fwd=0, dkv=0, dq=0, ref=0)
            with torch.no_grad():
                out = model(pt.to_tensor(src), pt.to_tensor(tgt),
                            src_mask=pt.to_tensor(pad),
                            memory_mask=pt.to_tensor(pad))
            if dev == "cuda":
                torch.cuda.synchronize()
                assert attn.ROUTE_STATS["pallas"] == 2
                assert fa.FLASH_ROUTE_STATS == {"fwd": 2, "dkv": 0, "dq": 0,
                                                "ref": 0}
            outs.append(out._value.cpu())
    finally:
        pt.set_device("cuda")
    _close(outs[0], outs[1], 1e-4, "transformer")


def test_lstm_on_the_card_equals_the_cpu():
    """A 2-layer bidirectional LSTM, forward and gradients, on the card
    against the CPU (f32, TF32 off)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import state_from_numpy

    rng = np.random.RandomState(8)
    x, w = rng.randn(3, 20, 16).astype(np.float32), rng.randn(
        3, 20, 64).astype(np.float32)
    got = {}
    try:
        for dev in ("cuda", "cpu"):
            pt.set_device(dev)
            pt.seed(4)
            lstm = nn.LSTM(16, 32, num_layers=2, direction="bidirect")
            if dev == "cpu":
                lstm.set_state_dict(state_from_numpy(state, "cpu"))
            else:
                state = {k: v.numpy() for k, v in lstm.state_dict().items()}
            xt = pt.to_tensor(x, stop_gradient=False)
            out, (h, c) = lstm(xt)
            (out * pt.to_tensor(w)).sum().backward()
            got[dev] = [t._value.detach().cpu() for t in (out, h, c, xt.grad)]
            got[dev] += [p.grad._value.cpu()
                         for p in lstm.state_dict().values()]
    finally:
        pt.set_device("cuda")
    for i, (a, b) in enumerate(zip(got["cuda"], got["cpu"])):
        _close(a, b, 1e-4, f"lstm[{i}]")


# --------------------------------------------------------------------------
# hapi: the train step as one CUDA graph
# --------------------------------------------------------------------------
_FIT_CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                ffn_size=256, max_seq_len=256)


def _fit_model(accelerate):
    from paddle_tpu_torch import Model, nn, optimizer
    from paddle_tpu_torch.optimizer import lr as sched
    from paddle_tpu_torch.text.models import GPTModel

    net = GPTModel(**_FIT_CFG, device="cuda", seed=7)
    opt = optimizer.AdamW(sched.StepDecay(1e-3, 1, 0.5),
                          parameters=list(net.parameters()),
                          weight_decay=0.1,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0))
    model = Model(net)
    model.prepare(opt, nn.CrossEntropyLoss(), accelerate=accelerate)
    return model, net, opt


def _fit_batches(n):
    rng = np.random.RandomState(3)
    ids = rng.randint(0, _FIT_CFG["vocab_size"], (n, 4, 257))
    return [(torch.from_numpy(b[:, :-1]).cuda(), torch.from_numpy(b[:, 1:])
             .cuda()) for b in ids]


def test_graphed_fit_step_equals_the_eager_step_bit_for_bit():
    """Three ``train_batch`` steps with the LR halving every step: the
    graphed path captures once, replays twice, and its losses and
    weights equal the eager path's bit for bit; the flash kernels run
    each step on both paths."""
    from paddle_tpu_torch.profiler.jit_cost import compile_budget

    out = {}
    for accelerate in (True, False):
        model, net, opt = _fit_model(accelerate)
        fa.FLASH_ROUTE_STATS.update(fwd=0, dkv=0, dq=0, ref=0)
        losses = []
        with compile_budget(None, names=("hapi/train_step",)) as cb:
            for x, y in _fit_batches(3):
                losses.append(model.train_batch([x], [y])[0])
                opt._lr.step()
        out[accelerate] = (losses, [p.detach().clone()
                                    for p in net.parameters()],
                           cb.compiles(), dict(fa.FLASH_ROUTE_STATS))
    (gl, gw, gc, gs), (el, ew, ec, es) = out[True], out[False]
    assert gc == {"hapi/train_step": 1} and ec == {}
    assert gl == el
    assert all(torch.equal(a, b) for a, b in zip(gw, ew))
    n = _FIT_CFG["num_layers"] * 3
    assert gs == es == {"fwd": n, "dkv": n, "dq": n, "ref": 0}


def _drop_net(dropout):
    """Embedding, one transformer encoder layer and a head over 64 ids:
    paddle-API layers, on the default device."""
    from paddle_tpu_torch import nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(64, 64)
            self.enc = nn.TransformerEncoderLayer(64, 4, 128,
                                                  dropout=dropout)
            self.head = nn.Linear(64, 64)

        def forward(self, x):
            return self.head(self.enc(self.emb(x)))

    return Net()


def _fit_random(case, accelerate, lr, seq):
    """Three train batches of one batch from ``pt.seed(11)``, every run
    from the same weights: (losses, weights, captures, flash counts)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import Model, nn, optimizer
    from paddle_tpu_torch.nn import state_from_numpy
    from paddle_tpu_torch.profiler.jit_cost import compile_budget

    pt.set_device("cuda")
    net = _drop_net(0.0 if case == "dpsgd" else 0.1)
    rng = np.random.RandomState(2)
    net.set_state_dict(state_from_numpy(
        {k: rng.randn(*v.shape).astype(np.float32) * 0.1
         for k, v in net.state_dict().items()}, "cuda"))
    opt = (optimizer.Dpsgd(lr, clip=1.0, batch_size=4.0, sigma=0.5,
                           parameters=net.parameters())
           if case == "dpsgd" else
           optimizer.AdamW(lr, parameters=net.parameters(),
                           weight_decay=0.1))
    model = Model(net)
    model.prepare(opt, nn.CrossEntropyLoss(), accelerate=accelerate)
    ids = rng.randint(0, 64, (2, seq + 1))
    x = torch.from_numpy(ids[:, :-1]).cuda()
    y = torch.from_numpy(ids[:, 1:]).cuda()
    fa.FLASH_ROUTE_STATS.update(fwd=0, dkv=0, dq=0, ref=0)
    pt.seed(11)
    with compile_budget(None, names=("hapi/train_step",)) as cb:
        losses = [model.train_batch([x], [y])[0] for _ in range(3)]
    weights = {k: v._value.detach().clone()
               for k, v in net.state_dict().items()}
    return losses, weights, cb.compiles(), dict(fa.FLASH_ROUTE_STATS)


@pytest.mark.parametrize("case,seq", [("flash", 256), ("plain", 32),
                                      ("dpsgd", 32)])
def test_graphed_fit_draws_anew_each_replay_as_the_eager_step(case, seq):
    """Dropout on the flash route (its seed an int32 tensor the kernels
    read on the card) and on the plain route, and ``Dpsgd``'s noise,
    inside the graphed train step: the port's generator is registered
    with the graph, so each replay draws what the eager step draws from
    the same state — losses and weights bit-equal over 3 steps with one
    capture — and, with dropout, each replay draws a new mask (at LR 0
    the same batch gives three losses)."""
    (gl, gw, gc, gs), (el, ew, ec, es) = (
        _fit_random(case, acc, 1e-3, seq) for acc in (True, False))
    assert gc == {"hapi/train_step": 1} and ec == {}
    assert gl == el, (gl, el)
    for k in gw:
        assert torch.equal(gw[k], ew[k]), k
    n = 3 if case == "flash" else 0
    assert gs == es == {"fwd": n, "dkv": n, "dq": n, "ref": 0}
    if case != "dpsgd":
        frozen = _fit_random(case, True, 0.0, seq)[0]
        assert len(set(frozen)) == 3, frozen


def test_cuda_names_the_current_cards_generator():
    from paddle_tpu_torch.framework.random import generator

    assert generator("cuda") is generator(
        torch.device("cuda", torch.cuda.current_device()))


def test_prefetched_graphed_step_does_not_sync():
    """Batches staged by ``prefetch_to_device`` (pinned memory, a side
    stream, an event) land on the card, and a steady graphed step — the
    staging of the next batch and the replay — makes no host sync; only
    the loss read after it does."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.tensor import Tensor

    model, net, opt = _fit_model(True)
    cpu = [(Tensor(x.cpu()), Tensor(y.cpu())) for x, y in _fit_batches(4)]
    it = io.prefetch_to_device(iter(cpu))
    x, y = next(it)
    assert x.place.type == "cuda"
    model.train_batch([x], [y])                       # the capture
    for _ in range(3):
        torch.cuda.set_sync_debug_mode("error")
        try:
            x, y = next(it)
            loss, _, _ = model._run_train_step(x._value, y._value)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert np.isfinite(float(loss))


# --------------------------------------------------------------------------
# the conv nets and BERT (ResNet, batch norm, NHWC, the bench-form step)
# --------------------------------------------------------------------------
def test_flash_kernels_match_plain_versions_at_bert_base_shape():
    """#5-#7 at ``bench.py``'s BERT-base shape: B 32, H 12, S 128, D 64,
    not causal, a kv mask padding some rows, dropout 0.1, bf16."""
    B, H, S, D, p, seed = 32, 12, 128, 64, 0.1, 7
    q, k, v, g, mask = _flash_case(11, B, H, S, D, torch.bfloat16, True)
    scale = 1.0 / np.sqrt(D)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    ref_o, ref_lse = fa.flash_fwd_ref(qf, kf, vf, mask, seed, scale, False,
                                      p)
    delta = (gf * ref_o).sum(-1).reshape(B * H, S, 1)
    fa.FLASH_TC_STATS.update(fwd=0, dkv=0, dq=0)
    o, lse = fa._flash_fwd_bhsd(q, k, v, mask, seed, scale, False, p)
    dk, dv = fa._flash_dkv_bhsd(q, k, v, g, ref_lse, delta, mask, seed,
                                scale, False, p)
    dq = fa._flash_dq_bhsd(q, k, v, g, ref_lse, delta, mask, seed, scale,
                           False, p)
    torch.cuda.synchronize()
    assert fa.FLASH_TC_STATS == {"fwd": 1, "dkv": 1, "dq": 1}
    rdk, rdv = fa.flash_dkv_ref(qf, kf, vf, gf, ref_lse, delta, mask, seed,
                                scale, False, p)
    rdq = fa.flash_dq_ref(qf, kf, vf, gf, ref_lse, delta, mask, seed, scale,
                          False, p)
    for name, got, want in (("o", o, ref_o), ("dk", dk, rdk),
                            ("dv", dv, rdv), ("dq", dq, rdq)):
        _close(got, want, TOL[torch.bfloat16], name,
               chip_smoke.FLASH_REL_L2[torch.bfloat16])
    _close(lse, ref_lse, 1e-4, "lse")


def _copy_kernels(fn):
    """Names of the device kernels ``fn`` launches that copy or
    transpose memory."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and chip_smoke.conv_family(e.key) == "copies"]


def test_nhwc_conv_bn_relu_pool_block_makes_no_copy_kernels():
    """A channel-last Conv2D -> BatchNorm2D(act="relu") -> MaxPool2D on a
    contiguous [N, H, W, C] input, forward and backward with a
    contiguous [N, H, W, C] gradient, in bf16 as under AMP (the conv's
    input and weight bf16, the norm's parameters and statistics f32):
    cuDNN, the norm and the pool read the channels_last views as they
    are, and the norm writes bf16 from its last op — not one copy,
    cast or transpose kernel.  (In f32 cuDNN transposes NHWC to NCHW
    itself, ``nhwcToNchwKernel``: the f32 path is best run NCHW.)"""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn

    pt.set_device("cuda")
    pt.seed(0)
    block = nn.Sequential(nn.Conv2D(64, 64, 3, padding=1, bias_attr=False,
                                    data_format="NHWC"),
                          nn.BatchNorm2D(64, data_format="NHWC", act="relu"),
                          nn.MaxPool2D(3, 2, 1, data_format="NHWC"))
    w = block[0].weight
    w._value = w._value.detach().to(torch.bfloat16).requires_grad_(True)
    assert w._value.is_contiguous(memory_format=torch.channels_last)
    x = pt.to_tensor(np.random.RandomState(0).randn(8, 56, 56, 64).astype(
        np.float32), dtype="bfloat16", stop_gradient=False)
    g = torch.randn(8, 28, 28, 64, device="cuda").to(torch.bfloat16)

    def step():
        out = block(x)
        assert out.shape == [8, 28, 28, 64]
        out._value.backward(g)

    step()                                  # warm-up: cuDNN's plans
    assert _copy_kernels(step) == []
    assert x.grad is not None and block[0].weight.grad is not None


def _resnet18_bench(graphed, remat=False, steps=2):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    pt.set_device("cuda")
    pt.seed(0)
    model = resnet18(num_classes=10, data_format="NHWC", remat=remat)
    step, state = chip_smoke.build_step(
        model, nn.CrossEntropyLoss(),
        Momentum(0.1, 0.9, parameters=model.parameters()), amp_dtype=None,
        graphed=graphed)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 64, 64, 3).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 10, (4,)).astype(np.int64)).cuda()
    losses = [float(step(state, x, y)) for _ in range(steps)]
    return model, losses


def test_graphed_resnet18_step_equals_the_eager_step_deterministically():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        graphed, gl = _resnet18_bench(True, steps=3)
        eager, el = _resnet18_bench(False, steps=3)
    finally:
        torch.backends.cudnn.deterministic = prev
    assert gl == el
    for (name, a), (_, b) in zip(graphed.state_dict().items(),
                                 eager.state_dict().items()):
        assert torch.equal(a._value, b._value), name


def test_remat_updates_the_running_statistics_once_on_the_card():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, pl = _resnet18_bench(False, steps=1)
        remat, rl = _resnet18_bench(False, remat=True, steps=1)
    finally:
        torch.backends.cudnn.deterministic = prev
    assert pl == rl
    for (name, a), (_, b) in zip(plain.named_buffers(),
                                 remat.named_buffers()):
        torch.testing.assert_close(b._value, a._value, rtol=1e-6, atol=1e-7,
                                   msg=name)


# --- numerical self-healing and loss scaling ---------------------------------
_MLP_BATCH, _MLP_BATCHES = 4, 10


def _guarded_mlp_fit(x, y, plan=None):
    """``Model.fit(anomaly=skip-only)`` of an MLP with dropout (8 -> 32,
    ``Dropout(0.3)``, ReLU, 32 -> 1; Adam) on the card, graphed, from
    ``pt.seed(7)``: (state, captures of hapi/train_step)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import Model, io, nn, optimizer
    from paddle_tpu_torch.hapi import AnomalyPolicy
    from paddle_tpu_torch.profiler.jit_cost import compile_budget
    from paddle_tpu_torch.testing import chaos

    pt.set_device("cuda")
    pt.seed(7)
    net = nn.Sequential(nn.Linear(8, 32), nn.Dropout(0.3), nn.ReLU(),
                        nn.Linear(32, 1))
    model = Model(net)
    model.prepare(optimizer.Adam(1e-2, parameters=net.parameters()),
                  nn.MSELoss())
    with compile_budget(None, names=("hapi/train_step",)) as cb, \
            chaos.running(plan or chaos.ChaosPlan([])):
        model.fit(io.TensorDataset([x, y]), batch_size=_MLP_BATCH,
                  shuffle=False, verbose=0,
                  anomaly=AnomalyPolicy(rollback_after=None,
                                        spike_window=0))
    state = {k: v._value.detach().clone()
             for k, v in net.state_dict().items()}
    state.update({f"opt/{k}": v for k, v in
                  model._optimizer.state_dict().items()
                  if torch.is_tensor(v)})
    return state, cb.compiles().get("hapi/train_step", 0)


@pytest.mark.parametrize("action", ["nan_loss", "nan_grad"])
def test_graphed_guarded_skip_equals_the_run_without_the_batch(action):
    """A chaos ``nan_loss`` / ``nan_grad`` at batch K of a graphed guarded
    fit with dropout: the step is discarded in place (the pre-step copy)
    and the port's generator rewound between replays, so the parameters
    and Adam's moments equal, bit for bit, the fit over the same batches
    without batch K — the masks after K are the ones drawn had K never
    come.  One capture in both."""
    from paddle_tpu_torch.testing import chaos

    K = 3
    rng = np.random.RandomState(0)
    x = rng.randn(_MLP_BATCH * _MLP_BATCHES, 8).astype(np.float32)
    y = (x @ rng.randn(8, 1)).astype(np.float32)
    plan = chaos.ChaosPlan([chaos.Fault("train.step", at=K + 1,
                                        action=action)])
    skipped, n_skip = _guarded_mlp_fit(x, y, plan)
    keep = np.ones(len(x), bool)
    keep[K * _MLP_BATCH:(K + 1) * _MLP_BATCH] = False
    clean, n_clean = _guarded_mlp_fit(x[keep], y[keep])
    assert n_skip == n_clean == 1
    assert plan.fired_log() and skipped.keys() == clean.keys()
    for k in clean:
        assert torch.equal(skipped[k], clean[k]), k


def test_grad_scaler_step_reads_the_host_once():
    """``GradScaler.step`` unscales every gradient and reduces their
    finiteness on the card, then reads one flag: one host sync under
    ``set_sync_debug_mode`` (``update`` none), whatever the number of
    parameters."""
    import warnings

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.amp import GradScaler

    pt.set_device("cuda")
    pt.seed(1)
    net = nn.Sequential(*[nn.Linear(16, 16) for _ in range(6)])
    opt = optimizer.AdamW(1e-3, parameters=net.parameters())
    scaler = GradScaler(init_loss_scaling=2.0 ** 10)
    x = pt.to_tensor(np.ones((4, 16), np.float32))
    for poison in (False, True):
        scaler.scale(net(x).sum()).backward()
        if poison:
            net[2].weight._value.grad.view(-1)[3] = float("inf")
        torch.cuda.synchronize()
        before = [p._value.detach().clone() for p in net.parameters()]
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                scaler.step(opt)
                scaler.update()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in seen if "synchroniz" in str(w.message)]
        assert len(syncs) == 1, [str(w.message) for w in seen]
        opt.clear_grad()
        moved = [not torch.equal(b, p._value)
                 for b, p in zip(before, net.parameters())]
        assert all(moved) if not poison else not any(moved)
    assert scaler.get_loss_scaling() == 2.0 ** 9


def _param_attr_fit(accelerate):
    """``Model.fit`` over an MLP whose layers carry ``ParamAttr``
    settings (a learning-rate scale and its own ``L2Decay``, a frozen
    bias, a weight outside the global-norm clip), 2 epochs of 3 batches
    from one seed: (losses, weights, captures)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import Model, nn, optimizer
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.profiler.jit_cost import compile_budget

    pt.set_device("cuda")
    pt.seed(5)
    net = nn.Sequential(
        nn.Linear(16, 32, weight_attr=pt.ParamAttr(
            learning_rate=0.5, regularizer=pt.regularizer.L2Decay(1e-3)),
            bias_attr=pt.ParamAttr(trainable=False)),
        nn.Tanh(),
        nn.Linear(32, 4, weight_attr=pt.ParamAttr(need_clip=False)))
    opt = optimizer.Adam(1e-2, parameters=net.parameters(),
                         grad_clip=nn.ClipGradByGlobalNorm(0.5))
    model = Model(net)
    model.prepare(opt, nn.MSELoss(), accelerate=accelerate)
    r = np.random.RandomState(5)
    data = TensorDataset([r.uniform(-1, 1, (24, 16)).astype(np.float32),
                          r.uniform(-1, 1, (24, 4)).astype(np.float32)])
    losses = []

    class Keep(pt.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    with compile_budget(None, names=("hapi/train_step",)) as cb:
        model.fit(data, batch_size=8, epochs=2, shuffle=False, verbose=0,
                  callbacks=[Keep()])
    return losses, [p._value.detach().clone() for p in net.parameters()], \
        cb.compiles()


def test_graphed_fit_with_param_attr_equals_the_eager_fit():
    """The ``ParamAttr`` settings hold inside the graphed train step as
    in the eager one: losses and weights bit-equal, one capture; the
    frozen bias never moves."""
    gl, gw, gc = _param_attr_fit(True)
    el, ew, ec = _param_attr_fit(False)
    assert gc == {"hapi/train_step": 1} and ec == {}
    assert len(gl) == 6 and str(gl) == str(el), (gl, el)
    assert all(torch.equal(a, b) for a, b in zip(gw, ew))
    assert torch.equal(gw[1], torch.zeros_like(gw[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_ring_on_slots_matches_the_plain_ring(dtype, causal):
    """Ring attention over sp 4 slots of cuda:0 at S_local 128: the flash
    ring (#5-#7 per visible chunk pair, no plain-route call) against the
    plain einsum ring on the same shards, output and dq/dk/dv, within the
    flash kernels' tolerance."""
    import functools

    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.distributed.ring_attention import ring_attention

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    q, k, v, cot = (torch.randn((2, 512, 4, 64), generator=g,
                                device="cuda").to(dtype) for _ in range(4))
    prev = dmesh.force_device_count(4)
    try:
        mesh = dmesh.init_mesh({"sp": 4})
        spec = dmesh.P(None, "sp", None, None)
        runs = {}
        for flash in (True, False):
            for c in fa.FLASH_ROUTE_STATS:
                fa.FLASH_ROUTE_STATS[c] = 0
            fn = dmesh.shard_map(
                functools.partial(ring_attention, axis_name="sp",
                                  causal=causal, use_flash=flash),
                mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fn(*leaves)
            grads = torch.autograd.grad(out, leaves, grad_outputs=cot)
            torch.cuda.synchronize()
            runs[flash] = ([out.detach()] + list(grads),
                           dict(fa.FLASH_ROUTE_STATS))
    finally:
        dmesh.force_device_count(prev)
    pairs = 10 if causal else 16
    assert runs[True][1] == {"fwd": pairs, "dkv": pairs, "dq": pairs,
                             "ref": 0}
    for got, want in zip(runs[True][0], runs[False][0]):
        want = want.float()
        err = float((got.float() - want).abs().max())
        assert err <= TOL[dtype] * max(1.0, float(want.abs().max()))
        assert chip_smoke.flash_rel_l2(got, want) <= \
            chip_smoke.FLASH_REL_L2[dtype]
