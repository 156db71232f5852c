"""paddle_tpu_torch on the card: the CUDA kernels against their plain
PyTorch versions, and the engine's streams against the dense
``generate``, native and int8.

Every test here is marked ``cuda`` and skips itself where
``torch.cuda.is_available()`` is False.  The file imports no JAX (the
machine with the card has none); run it there without the suite's
conftest, which imports JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: kernel vs plain version 1e-4 in f32 (the same f32 products
summed in another order, online softmax over up to 1024 positions; int8
pools add the scale multiply before or after the dot) and 2e-2 in bf16
(the kernel rounds its f32 result to bf16, 8 mantissa bits).  The
weight-only int8 matmul: 1e-4 absolute and relative in f32 (f32 sums
over K <= 3072 in another order), 1e-2 in bf16.  Streams must be equal
token for token.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quantized_matmul as qm

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
        pa.PAGED_ROUTE_STATS.update(cuda=0, cuda_int8=0, ref=0)
        ids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        outs = eng.drain()
        dispatches = eng.stats()["metrics"]["ragged"]["steps"]
        assert pa.PAGED_ROUTE_STATS == {"cuda": 2 * dispatches,
                                        "cuda_int8": 0, "ref": 0}
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
            pa.PAGED_ROUTE_STATS.update(cuda=0, cuda_int8=0, ref=0)
            qm.QMM_ROUTE_STATS.update(cuda=0, ref=0)
            ids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
            outs = eng.drain()
            dispatches = eng.stats()["metrics"]["ragged"]["steps"]
            assert pa.PAGED_ROUTE_STATS == {"cuda": 0,
                                            "cuda_int8": 2 * dispatches,
                                            "ref": 0}
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
