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
kernels: 1e-4 in f32 and 2e-2 in bf16, times max(1, the largest
reference value) (f32 sums over up to 1024 keys or queries in another
order; in bf16 the outputs are rounded to 8 mantissa bits, and the
forward and dK/dV, which run on the tensor cores, also round P and dS to
bf16 before their second product, where the plain version keeps them in
f32 — ``tests/test_torch_flash_tc_numerics.py`` shows on the CPU that
this fits the limit); in bf16 besides, each whole output within 1e-2
of its plain version in relative L2 norm (``chip_smoke.FLASH_REL_L2``:
the roundings land at 1.8e-3 to 2.8e-3 in the CPU emulation, a dropped
key tile at 0.18); lse 1e-4; their dropout bits must equal
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

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Qb", [1, 3, 8, 64])
@pytest.mark.parametrize("H,D,P,M", [(2, 16, 4, 6), (12, 64, 16, 8),
                                     (4, 128, 16, 4), (3, 48, 5, 7)],
                         ids=["test-shape", "gpt2", "d128", "odd"])
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
@pytest.mark.parametrize("Qb", [1, 3, 8, 64])
@pytest.mark.parametrize("H,D,P,M", [(2, 16, 4, 6), (12, 64, 16, 8),
                                     (4, 128, 16, 4), (3, 48, 5, 7),
                                     (2, 20, 4, 5)],
                         ids=["test-shape", "gpt2", "d128", "odd",
                              "bytewise-d20"])
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
@pytest.mark.parametrize("M", [1, 8, 37, 512])
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
    # a row's result does not depend on the other rows of the launch
    one = qm.quantized_matmul(x[M // 2:M // 2 + 1].contiguous(), wq, ws)
    assert torch.equal(one[0], out[M // 2])


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
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(4, 1, 1, 160, device="cuda")
        pools = torch.zeros(8, 4, 1, 160, device="cuda")
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
                (3, 48, 5, 7), (2, 20, 4, 5)],
    ids=["test-shape", "gpt2", "d128", "odd", "bytewise-d20"])


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
    with pytest.raises(ValueError, match="head_dim 160 > 128"):
        big = torch.zeros(4, 1, 160, device="cuda")
        pools = torch.zeros(8, 4, 1, 160, device="cuda")
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


def _page_ok(pt, owner_none=3):
    """Every second table entry owned; lane ``owner_none`` owns nothing."""
    ok = (torch.arange(pt.shape[1], device=pt.device)[None, :] % 2 == 0
          ).expand_as(pt).to(torch.int32).contiguous()
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Qb", [1, 3, 8, 64])
@pytest.mark.parametrize("H,D,P,M", [(2, 16, 4, 6), (12, 64, 16, 8),
                                     (6, 64, 16, 8), (4, 128, 16, 4),
                                     (3, 48, 5, 7)],
                         ids=["test-shape", "gpt2", "gpt2-tp2", "d128",
                              "odd"])
def test_stats_kernel_matches_plain_version(H, D, P, M, Qb, dtype):
    q, kp, vp, pt, rl = _case(0, 5, Qb, H, D, P, M, dtype)
    ok = _page_ok(pt)
    _zero_counts()
    o, lse = pa.ragged_paged_attention_stats(q, kp, vp, pt, rl, ok)
    torch.cuda.synchronize()
    assert pa.PAGED_ROUTE_STATS == _counts(cuda_stats=1)
    ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(
        q.float(), kp.float(), vp.float(), pt, rl, ok)
    _check_stats(o, lse, ref_o, ref_lse, rl, ok, dtype)
    assert o.dtype == dtype and o.shape == q.shape


@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "unfused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Qb", [1, 8, 64])
@pytest.mark.parametrize("H,D,P,M", [(2, 16, 4, 6), (12, 64, 16, 8),
                                     (6, 64, 16, 8), (3, 48, 5, 7),
                                     (2, 20, 4, 5)],
                         ids=["test-shape", "gpt2", "gpt2-tp2", "odd",
                              "bytewise-d20"])
def test_int8_stats_kernel_matches_plain_version(H, D, P, M, Qb, dtype,
                                                 fused):
    q, kq, vq, pt, rl, ks, vs = _int8(_case(0, 5, Qb, H, D, P, M, dtype))
    ok = _page_ok(pt)
    _zero_counts()
    o, lse = pa.ragged_paged_attention_stats(q, kq, vq, pt, rl, ok, ks, vs,
                                             fused_dequant=fused)
    torch.cuda.synchronize()
    assert pa.PAGED_ROUTE_STATS == _counts(cuda_stats_int8=1)
    ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(
        q.float(), kq, vq, pt, rl, ok, ks, vs)
    _check_stats(o, lse, ref_o, ref_lse, rl, ok, dtype)


@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "unfused"])
def test_int8_stats_kernel_nan_scale_reaches_exactly_its_readers(fused):
    """A NaN K scale on an owned page reaches exactly the rows that read
    it; one on a page this shard does not own reaches nobody."""
    q, kq, vq, pt, rl, ks, vs = _int8(_case(3, 5, 8, 12, 64, 16, 8,
                                            torch.float32))
    ok = _page_ok(pt, owner_none=0)
    ks[int(pt[3, 2]), 5] = float("nan")    # lane 3's third page: owned
    ks[int(pt[3, 1]), 6] = float("nan")    # its second: not owned
    o, lse = pa.ragged_paged_attention_stats(q, kq, vq, pt, rl, ok, ks, vs,
                                             fused_dequant=fused)
    ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(q, kq, vq, pt, rl,
                                                         ok, ks, vs)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(o).all(dim=-1)                    # [G, Qb, H]
    want = ~torch.isfinite(ref_o).all(dim=-1)
    assert want.any() and torch.equal(bad, want)
    # the readers: head 5 of lane 3's rows that see past position 32
    assert torch.equal(bad[3, :, 5], rl[3] > 32)
    assert not bad[:, :, [h for h in range(12) if h != 5]].any()
    fin = ~want[..., None].expand_as(o)
    torch.testing.assert_close(o[fin], ref_o[fin], rtol=0, atol=1e-4)
    torch.testing.assert_close(lse[~want], ref_lse[~want], rtol=0,
                               atol=LSE_TOL)


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
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(4, 1, 1, 160, device="cuda")
        pools = torch.zeros(8, 4, 1, 160, device="cuda")
        pa.ragged_paged_attention_stats(big, pools, pools, pt, rl, ok)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
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
    """The bf16 bodies (forward and dK/dV on the tensor cores, dQ on the
    CUDA cores) apply exactly ``_keep_mask``'s bits."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Sq,Sk,D,causal",
                         [(1000, 1000, 100, True), (333, 1000, 100, False),
                          (300, 700, 64, False), (700, 300, 64, True),
                          (500, 260, 80, False)],
                         ids=["d100", "d100_sq333_sk1000",
                              "sq300_sk700", "sq700_sk300_causal",
                              "d80_sq500_sk260"])
def test_flash_kernels_unaligned_rows_and_unequal_lengths(Sq, Sk, D, causal,
                                                          dtype):
    """Rows of D = 100 bf16 (not a multiple of 16 bytes: loaded element by
    element) and Sq != Sk (as ring attention calls the bodies) against
    the plain versions, with a padded kv mask and dropout."""
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


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_bf16_flash_kernels_are_deterministic(p):
    """Two launches of each bf16 body on the same inputs give the same
    bits (no atomics, a fixed order of sums)."""
    B, H, S, D = 2, 4, 1000, 64
    q, k, v, g, mask = _flash_case(11, B, H, S, D, torch.bfloat16, True)
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
    """FLASH_TC_STATS counts one launch of the bf16 forward and of the
    bf16 dK/dV; f32 and the dQ body leave it alone, FLASH_ROUTE_STATS
    counts every launch as before."""
    B, H, S, D = 1, 2, 128, 64
    for dtype, tc in ((torch.float32, 0), (torch.bfloat16, 1)):
        q, k, v, g, mask = _flash_case(3, B, H, S, D, dtype, False)
        lse = torch.zeros(B * H, S, 1, device="cuda")
        fa.FLASH_ROUTE_STATS.update(fwd=0, dkv=0, dq=0, ref=0)
        fa.FLASH_TC_STATS.update(fwd=0, dkv=0)
        _flash_all(q, k, v, g, mask, 0, 0.125, True, 0.0, lse, lse)
        torch.cuda.synchronize()
        assert fa.FLASH_ROUTE_STATS == {"fwd": 1, "dkv": 1, "dq": 1,
                                        "ref": 0}
        assert fa.FLASH_TC_STATS == {"fwd": tc, "dkv": tc}


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
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        h = q.half()
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
    assert res["cpu_counts"]["flash_ref"] == 6


def test_autocast_training_step_on_the_card_equals_the_cpu_step():
    """The same 2-layer step with the forward under
    ``amp.auto_cast(dtype="bfloat16")``: loss and gradients against the
    CPU's plain route at bf16 tolerances, the card's AdamW step against
    the same step on the CPU from the card's gradients (chip_smoke's
    train_parity_bf16 phase at a small width; it raises past its
    tolerances), with the flash forward and dK/dV on the tensor cores."""
    cfg = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
               ffn_size=256, max_seq_len=256)
    res = chip_smoke.train_parity_bf16_phase(np.random.RandomState(3),
                                             cfg=cfg, batch=2, seq=256)
    assert res["card_counts"]["flash_tc_fwd"] == 2
    assert res["card_counts"]["flash_tc_dkv"] == 2
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
