"""paddle_tpu_torch on the card: the CUDA kernels against their plain
PyTorch versions, the engine's streams against the dense ``generate``,
native and int8, and a training step against the same step on the CPU.

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
over K <= 3072 in another order), 1e-2 in bf16.  The flash attention
kernels: 1e-4 in f32 and 2e-2 in bf16, times max(1, the largest
reference value) (f32 sums over up to 1024 keys or queries in another
order; bf16 outputs rounded to 8 mantissa bits); their dropout bits must
equal ``_keep_mask``'s exactly.  Streams must be equal token for token.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.ops import flash_attention as fa
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


def _close(got, want, tol, what):
    want = want.float()
    err = float((got.float() - want).abs().max())
    limit = tol * max(1.0, float(want.abs().max()))
    assert err <= limit, f"{what}: max_abs_err {err} > {limit}"


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
        _close(got, want, tol, name)
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
