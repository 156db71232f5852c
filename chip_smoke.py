"""On-card smoke run of the PyTorch/CUDA port (paddle_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out FILE.json]

Phases, one result line each (or more):

1. env: card name and power limit (nvidia-smi), torch / CUDA versions,
   and the seconds it took to build the CUDA kernels from
   ``paddle_tpu_torch/ops/csrc/*.cu`` (one ``nvcc`` per source, started
   together).
2. kernel: the ragged paged-attention kernel against its plain PyTorch
   version on the card, in f32 (and once in bf16), at the test shapes and
   at GPT-2-small shapes, with mixed row lengths (empty rows, rows
   shorter than their lane, lengths that are not page multiples).  Timed
   with CUDA events beside the plain version and the
   ``scaled_dot_product_attention`` yardstick over the gathered dense KV.
3. kernel_int8: the same kernel's int8 body (int8 pools, [N, H] f32
   scales) in both ``fused_dequant`` settings, f32 q (and once bf16 q),
   at the same shapes, plus a NaN in one K scale row (non-finite exactly
   on the rows that read it); timed beside its plain version and SDPA
   over the dequantized dense KV.
4. kernel_qmm: the weight-only int8 matmul against its plain version at
   GPT-2-small's weight shapes (q/k/v/out 768x768, fc1 768x3072, fc2
   3072x768) and an odd edge shape, M in {1, 8, 37, 512}, f32 and bf16
   x; timed beside the plain version and ``torch.matmul`` on a
   pre-dequantized f32 weight.
5. e2e: GPT-2-small width (vocab 50304, hidden 768, 12 layers, 12 heads,
   ffn 3072, max_seq_len 1024, f32, seeded random weights) served by
   ``create_serving_engine`` on 8 requests; every attention call must go
   through the kernel, no page may leak, and every stream must equal the
   port's dense ``generate`` except at a reported near-tie.
6. e2e_int8_static: the same model and requests with
   ``kv_cache_dtype="int8"``, ``weight_dtype="int8"`` and an export
   calibrated on the card; every attention call on the int8 body, every
   projection and MLP matmul on the int8 matmul kernel, streams equal to
   ``generate(quant=export)`` except at a reported near-tie, no page
   leaked, KV bytes at most 0.26x the native engine's.
7. e2e_int8_dynamic: no KV calibration (dynamic per-page scales); 4 of
   the requests, synchronous and pipelined: streams byte-identical, no
   page leaked.

Every failure raises (nonzero exit).  The last three lines of standard
output are the card's name and power limit, the kernel record and
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
nonzero before printing a result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# kernel vs plain version: f32 sums over up to 1024 positions in another
# order (online softmax, tile-wise) — 1e-4 absolute on outputs of
# magnitude ~1; bf16 inputs are compared after the kernel rounds its
# output to bf16 (8 mantissa bits: ~4e-3 relative)
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the weight-only int8 matmul vs its plain version: f32 sums over
# K <= 3072 in another order (outputs of magnitude ~1); bf16 x is compared
# after the kernel rounds its output to bf16
QMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# a greedy stream may leave the dense reference only where the
# reference's top-2 logit gap is below this: the engine and the dense
# ring sum the same f32 products in another order (chunked prefill,
# paged kernel), which moves logits by ~1e-5
NEAR_TIE_GAP = 1e-3
# int8 KV widens that: where the engine's and the dense ring's f32 K or V
# differ by an ulp across a quantization boundary, the stored int8
# differs by one quantum (the head's abs-max / 127) at that position,
# a far larger step than the f32 summation order — hence ten times the
# native limit
INT8_NEAR_TIE_GAP = 1e-2

# where the kernel phases place their tensors (a CPU rehearsal of the
# script's logic sets "cpu" and routes the wrappers to the plain versions)
DEVICE = "cuda"

GPT2_SMALL = dict(vocab_size=50304, hidden_size=768, num_layers=12,
                  num_heads=12, ffn_size=3072, max_seq_len=1024)
PROMPT_LENS = (16, 45, 77, 128, 190, 257, 333, 400)
NEW_TOKENS = 32


def log(phase: str, **fields):
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------
def make_case(rng, *, G, Qb, H, D, P, M, lane_lens, row_gaps=None,
              dtype=torch.float32):
    """Random pools (trash page 0 included), distinct pages per lane and
    per-row lengths: row r of lane g sees lane_lens[g] - (Qb-1-r)
    positions (a prefill staircase); rows in row_gaps[g] are padding."""
    need = [-(-min(n, M * P) // P) for n in lane_lens]
    N = 1 + sum(need) + 3
    perm = rng.permutation(np.arange(1, N))
    pt = np.zeros((G, M), np.int32)
    at = 0
    for g in range(G):
        pt[g, :need[g]] = perm[at:at + need[g]]
        at += need[g]
    rl = np.zeros((G, Qb), np.int32)
    for g in range(G):
        for r in range(Qb):
            rl[g, r] = max(lane_lens[g] - (Qb - 1 - r), 0)
        for r in (row_gaps or {}).get(g, ()):
            rl[g, r] = 0
    q = torch.from_numpy(rng.randn(G, Qb, H, D).astype(np.float32))
    kp = torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32))
    return (q.to(DEVICE, dtype), kp.to(DEVICE, dtype), vp.to(DEVICE, dtype),
            torch.from_numpy(pt).to(DEVICE), torch.from_numpy(rl).to(DEVICE))


def bound_ms(q, k_pages, page_tables, row_lens):
    """Least time for this call's work on an H100: the larger of the bytes
    it must move (q and out once, each lane's K and V positions below its
    horizon once — with int8 pools, also each used page's two [H] f32
    scale rows — the row lengths and the used table entries) over HBM
    bandwidth, and its f32 flops (q.k and p.v: 4*D per visible position,
    row and head) over the f32 CUDA-core peak."""
    G, Qb, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    item = q.element_size()
    rl = row_lens.clamp(max=M * P).cpu().numpy().astype(np.int64)
    horizon = rl.max(axis=1)
    pages = int(sum(-(-int(h) // P) for h in horizon))
    kv_bytes = int(horizon.sum()) * H * D * k_pages.element_size() * 2
    if k_pages.dtype == torch.int8:
        kv_bytes += pages * H * 4 * 2
    table_bytes = pages * 4
    io_bytes = 2 * q.numel() * item + row_lens.numel() * 4
    t_bytes = (kv_bytes + table_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = int(rl.sum()) * H * D * 4 / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_inputs(q, k_pages, v_pages, page_tables, row_lens):
    """The yardstick's inputs: each lane's pages gathered into dense
    [G, H, S, D] K/V and a boolean [G, 1, Qb, S] visibility mask."""
    G, Qb, H, D = q.shape
    P = k_pages.shape[1]
    S = page_tables.shape[1] * P
    idx = page_tables.long()
    k = k_pages[idx].reshape(G, S, H, D).transpose(1, 2).contiguous()
    v = v_pages[idx].reshape(G, S, H, D).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            < row_lens.long()[:, None, :, None])
    return q.transpose(1, 2).contiguous(), k, v, mask


def time_ms(fn, flush, reps=30, warmup=3):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), the
    L2 cache flushed before each run, as the serving step finds it (12
    layers' pools exceed the 50 MB L2).  A device-side sleep ahead of the
    start event keeps the card busy while the host enqueues ``fn``, so
    the events bracket device work only, not host launch latency."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# the attention cases: the test width at three row counts, then
# GPT-2-small shapes — a decode batch and a prefill-chunk batch
ATTN_CASES = [("test", dict(G=3, Qb=Qb, H=2, D=16, P=4, M=5,
                            lane_lens=[0, 7, 19], row_gaps={2: [0]}))
              for Qb in (1, 3, 8)] + [
    ("gpt2_decode", dict(G=8, Qb=1, H=12, D=64, P=16, M=64,
                         lane_lens=[0, 1, 17, 100, 255, 512, 777, 1024])),
    ("gpt2_prefill", dict(G=8, Qb=64, H=12, D=64, P=16, M=64,
                          lane_lens=[0, 63, 130, 250, 401, 600, 900, 1024],
                          row_gaps={1: range(40, 64), 3: [5, 6, 7]}))]
TIMED = ("gpt2_decode", "gpt2_prefill")


def _tag(name, kw, dtype):
    return f"{name}/{str(dtype).split('.')[-1]}/Qb{kw['Qb']}"


def _check_close(phase, tag, out, ref, row_lens, tol, **extra):
    err = float((out.float() - ref).abs().max())
    zeros_exact = bool((out[row_lens == 0] == 0).all())
    ok = math.isfinite(err) and err <= tol and zeros_exact
    log(phase, case=tag, max_abs_err=err, tol=tol,
        empty_rows_exact_zero=zeros_exact, ok=ok, **extra)
    if not ok:
        raise AssertionError(f"{phase}: kernel disagrees with its plain "
                             f"version on {tag} {extra}: max_abs_err {err} "
                             f"(tol {tol}), empty rows exact zero: "
                             f"{zeros_exact}")
    return err


def kernel_phase(rng, flush) -> dict:
    from paddle_tpu_torch.ops import paged_attention as pa

    runs = [(name, kw, torch.float32) for name, kw in ATTN_CASES]
    runs.append(("gpt2_decode", ATTN_CASES[3][1], torch.bfloat16))
    checked = {}
    for name, kw, dtype in runs:
        args = make_case(rng, dtype=dtype, **kw)
        out = pa.ragged_paged_attention_cuda(*args)
        torch.cuda.synchronize()
        ref = pa.ragged_paged_attention_ref(
            *(a.float() if a.is_floating_point() else a for a in args))
        tag = _tag(name, kw, dtype)
        checked[tag] = (args, _check_close("kernel", tag, out, ref, args[4],
                                           KERNEL_TOL[dtype]))

    timings = {"bf16_max_abs_err": checked["gpt2_decode/bfloat16/Qb1"][1]}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in TIMED:
        tag = f"{name}/float32/Qb{dict(ATTN_CASES)[name]['Qb']}"
        args, err = checked[tag]
        q_d, k_d, v_d, mask = sdpa_inputs(*args)
        valid = args[4] > 0
        lib_out = sdpa(q_d, k_d, v_d, attn_mask=mask).transpose(1, 2)
        ref = pa.ragged_paged_attention_ref(*args)
        t = {"max_abs_err": err,
             "library_max_abs_err": float(
                 (lib_out[valid] - ref[valid]).abs().max()),
             "ms": time_ms(lambda: pa.ragged_paged_attention_cuda(*args),
                           flush),
             "plain_ms": time_ms(
                 lambda: pa.ragged_paged_attention_ref(*args), flush),
             "library_ms": time_ms(
                 lambda: sdpa(q_d, k_d, v_d, attn_mask=mask), flush)}
        t["bound_ms"], t["bound_by"] = bound_ms(args[0], args[1], args[3],
                                                args[4])
        log("kernel_time", case=tag, **t)
        timings[tag] = t
    return timings


def quantize_pools(k_pages, v_pages):
    """Pools quantized per (page, head) as the dynamic write path leaves
    a full page: scale = abs-max / 127 (floored), int8 = round(x / s)."""
    def quant(pool):
        x = pool.float()
        sc = (x.abs().amax(dim=(1, 3)) / 127.0).clamp(min=1e-8)
        q = torch.round(x / sc[:, None, :, None]).clamp(-127, 127)
        return q.to(torch.int8).contiguous(), sc.contiguous()

    kq, ks = quant(k_pages)
    vq, vs = quant(v_pages)
    return kq, vq, ks, vs


def int8_kernel_phase(rng, flush) -> dict:
    """Body #1q against its plain version in both fused_dequant settings
    (f32 q; bf16 q once), the NaN-scale case, and the decode/prefill
    timings of both settings."""
    from paddle_tpu_torch.ops import paged_attention as pa

    runs = [(name, kw, torch.float32, fused) for name, kw in ATTN_CASES
            for fused in (1, 0)]
    runs += [("gpt2_decode", ATTN_CASES[3][1], torch.bfloat16, fused)
             for fused in (1, 0)]
    checked = {}
    for name, kw, dtype, fused in runs:
        q, kp, vp, pt, rl = make_case(rng, dtype=dtype, **kw)
        kq, vq, ks, vs = quantize_pools(kp, vp)
        args = (q, kq, vq, pt, rl, ks, vs)
        out = pa.ragged_paged_attention_cuda(*args, fused_dequant=fused)
        torch.cuda.synchronize()
        ref = pa.ragged_paged_attention_ref(q.float(), *args[1:])
        tag = f"{_tag(name, kw, dtype)}/fused_dequant={fused}"
        checked[tag] = (args, _check_close("kernel_int8", tag, out, ref, rl,
                                           KERNEL_TOL[dtype]))

    # a NaN in one K scale row: non-finite exactly on the rows that read
    # that page (lane 5, horizon 512, reads page 3 = positions 48..63)
    nan_ok = {}
    for fused in (1, 0):
        args = list(checked[f"gpt2_decode/float32/Qb1/fused_dequant="
                            f"{fused}"][0])
        ks = args[5].clone()
        lane, head = 5, 7
        ks[int(args[3][lane, 3]), head] = float("nan")
        args[5] = ks
        out = pa.ragged_paged_attention_cuda(*args, fused_dequant=fused)
        ref = pa.ragged_paged_attention_ref(*args)
        torch.cuda.synchronize()
        bad = ~torch.isfinite(out).all(dim=-1)
        want = torch.zeros_like(bad)
        want[lane, 0, head] = True
        fin = ~bad[..., None].expand_as(out)
        err = float((out[fin] - ref[fin]).abs().max())
        ok = (torch.equal(bad, want)
              and torch.equal(~torch.isfinite(ref).all(dim=-1), want)
              and err <= KERNEL_TOL[torch.float32])
        log("kernel_int8", case="gpt2_decode/nan_k_scale", fused_dequant=fused,
            non_finite_rows=int(bad.sum()), max_abs_err_elsewhere=err, ok=ok)
        if not ok:
            raise AssertionError(f"NaN k_scale (fused_dequant={fused}): "
                                 f"non-finite at {bad.nonzero().tolist()}, "
                                 f"expected only {want.nonzero().tolist()}; "
                                 f"error elsewhere {err}")
        nan_ok[fused] = ok

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {"nan_scale_ok": all(nan_ok.values()),
               "bf16_max_abs_err": max(
                   checked[f"gpt2_decode/bfloat16/Qb1/fused_dequant={f}"][1]
                   for f in (1, 0))}
    for name in TIMED:
        for fused in (1, 0):
            tag = (f"{name}/float32/Qb{dict(ATTN_CASES)[name]['Qb']}"
                   f"/fused_dequant={fused}")
            args, err = checked[tag]
            q, kq, vq, pt, rl, ks, vs = args
            kd = kq.float() * ks[:, None, :, None]
            vd = vq.float() * vs[:, None, :, None]
            q_d, k_d, v_d, mask = sdpa_inputs(q, kd, vd, pt, rl)
            t = {"max_abs_err": err,
                 "ms": time_ms(lambda: pa.ragged_paged_attention_cuda(
                     *args, fused_dequant=fused), flush),
                 "plain_ms": time_ms(
                     lambda: pa.ragged_paged_attention_ref(*args), flush),
                 "library_ms": time_ms(
                     lambda: sdpa(q_d, k_d, v_d, attn_mask=mask), flush)}
            t["bound_ms"], t["bound_by"] = bound_ms(q, kq, pt, rl)
            log("kernel_int8_time", case=tag, **t)
            timings[tag] = t
    return timings


# the serving path's weight shapes (q/k/v/out share 768x768) and an odd
# shape for the edges (N not a multiple of 4: byte-wise weight loads)
QMM_SHAPES = {"proj_768x768": (768, 768), "fc1_768x3072": (768, 3072),
              "fc2_3072x768": (3072, 768), "odd_45x70": (45, 70)}
QMM_M = (1, 8, 37, 512)


def qmm_bound_ms(M, K, N, item):
    """Least time on an H100: x, the int8 weight, its scales and the
    output moved once over HBM bandwidth, or 2*M*K*N f32 operations over
    the f32 CUDA-core peak, whichever is larger."""
    t_bytes = (M * K * item + K * N + N * 4 + M * N * item) / HBM_BYTES_PER_S
    t_ops = 2 * M * K * N / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def qmm_phase(rng, flush) -> dict:
    """Body #4 against its plain version at every shape, M and dtype;
    timings at M 8 (decode) and 512 (a prefill chunk) in f32."""
    from paddle_tpu_torch.ops import quantized_matmul as qm

    timings = {}
    for sname, (K, N) in QMM_SHAPES.items():
        wq = torch.from_numpy(rng.randint(-127, 128, (K, N)).astype(
            np.int8)).to(DEVICE)
        ws = torch.from_numpy((rng.rand(N) * 0.04 / 127 + 1e-5).astype(
            np.float32)).to(DEVICE)
        w_deq = wq.float() * ws[None, :]
        for M in QMM_M:
            xf = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(
                DEVICE)
            for dtype in (torch.float32, torch.bfloat16):
                x = xf.to(dtype)
                out = qm.quantized_matmul_cuda(x, wq, ws)
                torch.cuda.synchronize()
                ref = qm.quantized_matmul_ref(x.float(), wq, ws)
                tol = QMM_TOL[dtype]
                err = float((out.float() - ref).abs().max())
                scale = float(ref.abs().max())
                ok = math.isfinite(err) and err <= tol * max(1.0, scale)
                tag = f"{sname}/M{M}/{str(dtype).split('.')[-1]}"
                log("kernel_qmm", case=tag, max_abs_err=err,
                    max_abs_ref=scale, tol=tol, ok=ok)
                if not ok:
                    raise AssertionError(
                        f"quantized matmul disagrees with its plain version "
                        f"on {tag}: max_abs_err {err} (tol {tol} x "
                        f"max(1, {scale}))")
                if dtype == torch.float32 and M in (8, 512) \
                        and not sname.startswith("odd"):
                    t = {"max_abs_err": err,
                         "ms": time_ms(lambda: qm.quantized_matmul_cuda(
                             x, wq, ws), flush),
                         "plain_ms": time_ms(
                             lambda: qm.quantized_matmul_ref(x, wq, ws),
                             flush),
                         "library_ms": time_ms(
                             lambda: torch.matmul(x, w_deq), flush)}
                    t["bound_ms"], t["bound_by"] = qmm_bound_ms(M, K, N, 4)
                    log("kernel_qmm_time", case=tag, **t)
                    timings[tag] = t
    return timings


# --------------------------------------------------------------------------
# end-to-end phases
# --------------------------------------------------------------------------
def logit_gap(model, prompt, stream, k, quant=None):
    """Top-2 logit gap of the dense reference at generated position k
    (teacher-forced through prompt + stream[:k]; int8 as ``quant`` says)."""
    from paddle_tpu_torch.text.generation import make_gpt_decode_step

    qkw = {}
    if quant is not None:
        qkw = dict(kv_cache_dtype=quant["kv_cache_dtype"],
                   kv_scales=quant["kv_scales"],
                   weight_quant=quant["weights"])
    ids = np.concatenate([prompt, stream[:k]]).astype(np.int32)
    step_fn, init_state = make_gpt_decode_step(model, ids.size + 1, **qkw)
    state = init_state(1)
    dev = model.device
    logits = None
    for tok in ids:
        logits, state = step_fn(torch.tensor([int(tok)], dtype=torch.int32,
                                             device=dev), state)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def reset_counts():
    from paddle_tpu_torch.ops.paged_attention import PAGED_ROUTE_STATS
    from paddle_tpu_torch.ops.quantized_matmul import QMM_ROUTE_STATS

    for stats in (PAGED_ROUTE_STATS, QMM_ROUTE_STATS):
        for key in stats:
            stats[key] = 0


def read_counts():
    from paddle_tpu_torch.ops.paged_attention import PAGED_ROUTE_STATS
    from paddle_tpu_torch.ops.quantized_matmul import QMM_ROUTE_STATS

    return ({f"attention_{k}": v for k, v in PAGED_ROUTE_STATS.items()}
            | {f"qmm_{k}": v for k, v in QMM_ROUTE_STATS.items()})


def drive(eng, prompts):
    """Serve ``prompts`` to completion with every launch count set to 0
    just before and read just after.  Returns (streams, counts, wall s,
    ragged dispatches)."""
    ids = [eng.add_request(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if eng.cache.pages_in_use != 0:
        raise AssertionError(f"{eng.cache.pages_in_use} KV pages leaked")
    streams = [outs[r] for r in ids]
    if [len(s) for s in streams] != [NEW_TOKENS] * len(ids):
        raise AssertionError(f"expected {NEW_TOKENS} tokens per request, "
                             f"got {[len(s) for s in streams]}")
    return streams, counts, wall, eng.stats()["metrics"]["ragged"]["steps"]


def expect_counts(phase, counts, want):
    got = {k: counts[k] for k in want}
    if got != want or not any(v > 0 for v in want.values()):
        raise AssertionError(f"{phase}: launch counts {counts}, expected "
                             f"{want}: the path did not run on the kernels "
                             f"at every layer of every dispatch")


def check_streams(phase, model, prompts, streams, quant=None):
    """Every stream against the port's dense generate (int8 per
    ``quant``) on the card; a divergence is allowed only at a near tie of
    the reference's top-2 logits."""
    from paddle_tpu_torch.text.generation import generate

    gap_limit = NEAR_TIE_GAP if quant is None else INT8_NEAR_TIE_GAP
    near_ties = []
    for i, (p, got) in enumerate(zip(prompts, streams)):
        want, _ = generate(model, p[None], max_new_tokens=NEW_TOKENS,
                           end_id=-1, quant=quant)
        want = want[0].cpu().numpy()
        if not np.isfinite(got).all() or got.shape != want.shape:
            raise AssertionError(f"{phase} request {i}: bad output {got}")
        diff = np.nonzero(got != want)[0]
        if diff.size:
            k = int(diff[0])
            gap = logit_gap(model, p, want, k, quant)
            case = {"request": i, "prompt_len": int(p.size), "position": k,
                    "engine": int(got[k]), "reference": int(want[k]),
                    "top2_gap": gap, "gap_limit": gap_limit}
            log(f"{phase}_near_tie", **case)
            if gap >= gap_limit:
                raise AssertionError(
                    f"{phase} request {i} diverges from generate at "
                    f"position {k} where the reference's top-2 gap {gap} "
                    f">= {gap_limit}")
            near_ties.append(case)
    return near_ties


def summary(eng, prompts, wall, dispatches, counts, near_ties):
    snap = eng.stats()["metrics"]
    n_tokens = NEW_TOKENS * len(prompts)
    return {"requests": len(prompts),
            "prompt_lens": [int(p.size) for p in prompts],
            "new_tokens": NEW_TOKENS, "engine_steps": snap["steps"],
            "ragged_dispatches": dispatches, "wall_s": wall,
            "output_tokens_per_s": n_tokens / wall, **counts,
            "pages_in_use_after_drain": eng.cache.pages_in_use,
            "streams_equal": len(prompts) - len(near_ties),
            "near_ties": len(near_ties),
            "kv_cache_bytes": eng.kv_cache_bytes(),
            "num_pages": eng.cache.num_pages,
            # the engine's own histograms (host clock): step latency,
            # the consume-side wait for a dispatch's tokens, and the
            # gap between consecutive dispatches
            "step_ms": snap["step_latency_ms"],
            "consume_wait_ms": snap["decode_latency_ms"],
            "dispatch_gap_ms": snap["dispatch_gap_ms"]}


ENGINE = dict(page_size=16, max_batch_size=8, prefill_chunk=64, eos_id=-1)


def e2e_phase(model, prompts, device="cuda") -> dict:
    """Native KV, f32 weights: attention on body #1 only."""
    from paddle_tpu_torch.serving import create_serving_engine

    eng = create_serving_engine(model, device=device, **ENGINE)
    streams, counts, wall, dispatches = drive(eng, prompts)
    L = len(model.layers)
    expect_counts("e2e", counts, {"attention_cuda": L * dispatches,
                                  "attention_cuda_int8": 0,
                                  "attention_ref": 0, "qmm_cuda": 0,
                                  "qmm_ref": 0})
    t0 = time.perf_counter()
    near = check_streams("e2e", model, prompts, streams)
    result = summary(eng, prompts, wall, dispatches, counts, near)
    result["reference_s"] = time.perf_counter() - t0
    log("e2e", **result)
    return result


def e2e_int8_static_phase(model, prompts, rng, native,
                          device="cuda") -> dict:
    """int8 KV with scales calibrated on the card, int8 weights: every
    attention call on body #1q, every projection/MLP matmul on body #4."""
    from paddle_tpu_torch.serving import create_serving_engine
    from paddle_tpu_torch.slim import export_serving_quant

    t0 = time.perf_counter()
    calib = rng.randint(1, model.wte.weight.shape[0], (4, 64))
    export = export_serving_quant(model, calib_prompts=calib)
    t_export = time.perf_counter() - t0
    eng = create_serving_engine(model, device=device, kv_cache_dtype="int8",
                                weight_dtype="int8", quant_scales=export,
                                **ENGINE)
    if eng.kv_mode() != "int8_static":
        raise AssertionError(f"engine runs {eng.kv_mode()}, not int8_static")
    streams, counts, wall, dispatches = drive(eng, prompts)
    L = len(model.layers)
    expect_counts("e2e_int8_static", counts, {
        "attention_cuda": 0, "attention_cuda_int8": L * dispatches,
        "attention_ref": 0, "qmm_cuda": 6 * L * dispatches, "qmm_ref": 0})
    # the same page count as the native engine, a quarter of its bytes
    ratio = eng.kv_cache_bytes() / native["kv_cache_bytes"]
    if eng.cache.num_pages != native["num_pages"] or ratio > 0.26:
        raise AssertionError(
            f"int8 KV bytes {eng.kv_cache_bytes()} over "
            f"{eng.cache.num_pages} pages are {ratio:.4f}x the native "
            f"engine's {native['kv_cache_bytes']} over "
            f"{native['num_pages']} (limit 0.26)")
    t0 = time.perf_counter()
    near = check_streams("e2e_int8_static", model, prompts, streams, export)
    result = summary(eng, prompts, wall, dispatches, counts, near)
    result.update(reference_s=time.perf_counter() - t0, export_s=t_export,
                  kv_bytes_vs_native=ratio,
                  kv_bytes_per_token=eng.kv_bytes_per_token(),
                  quant_weight_bytes=eng.stats()["quant"][
                      "quant_weight_bytes"])
    log("e2e_int8_static", **result)
    return result


def e2e_int8_dynamic_phase(model, prompts, device="cuda") -> dict:
    """No KV calibration: dynamic per-page scales; synchronous and
    pipelined drives must stream byte-identical tokens."""
    from paddle_tpu_torch.serving import create_serving_engine

    runs = {}
    L = len(model.layers)
    for sync_mode in (True, False):
        eng = create_serving_engine(model, device=device,
                                    kv_cache_dtype="int8",
                                    weight_dtype="int8", sync_mode=sync_mode,
                                    **ENGINE)
        if eng.kv_mode() != "int8_dynamic":
            raise AssertionError(f"engine runs {eng.kv_mode()}")
        streams, counts, wall, dispatches = drive(eng, prompts)
        expect_counts("e2e_int8_dynamic", counts, {
            "attention_cuda": 0, "attention_cuda_int8": L * dispatches,
            "attention_ref": 0, "qmm_cuda": 6 * L * dispatches,
            "qmm_ref": 0})
        runs[sync_mode] = (streams, summary(eng, prompts, wall, dispatches,
                                            counts, []))
        del eng
    same = all(np.array_equal(a, b) for a, b in zip(runs[True][0],
                                                    runs[False][0]))
    result = {"sync": runs[True][1], "pipelined": runs[False][1],
              "streams_byte_identical": same}
    log("e2e_int8_dynamic", **result)
    if not same:
        raise AssertionError("int8_dynamic: synchronous and pipelined "
                             "streams differ")
    return result


def record(name, source, replaces, launches, t, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}, **extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every phase's result to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2

    # f32 parity: no TF32 anywhere (matmuls and cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.text.models import GPTModel

    card = card_line()
    t0 = time.perf_counter()
    _build.load_libraries()
    log("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        build_s=time.perf_counter() - t0,
        builds={name: {"seconds": b["seconds"], "cached": b["cached"],
                       "ptxas": [ln for ln in b["ptxas"]
                                 if "registers" in ln or "spill" in ln]}
                for name, b in _build.build_log.items()})

    rng = np.random.RandomState(0)
    report = {"card": card}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")                     # 256 MB
    report["kernel"] = native_t = kernel_phase(rng, flush)
    report["kernel_int8"] = int8_t = int8_kernel_phase(rng, flush)
    report["kernel_qmm"] = qmm_t = qmm_phase(rng, flush)
    del flush

    t0 = time.perf_counter()
    model = GPTModel(**GPT2_SMALL, device="cuda", seed=1234)
    torch.cuda.synchronize()
    log("model", init_s=time.perf_counter() - t0)
    prompts = [rng.randint(1, GPT2_SMALL["vocab_size"], (n,)).astype(
        np.int32) for n in PROMPT_LENS]
    report["e2e"] = e2e = e2e_phase(model, prompts)
    torch.cuda.empty_cache()
    report["e2e_int8_static"] = st = e2e_int8_static_phase(
        model, prompts, rng, e2e)
    torch.cuda.empty_cache()
    report["e2e_int8_dynamic"] = e2e_int8_dynamic_phase(model, prompts[:4])

    dec = native_t["gpt2_decode/float32/Qb1"]
    idec = int8_t["gpt2_decode/float32/Qb1/fused_dequant=1"]
    qdec = qmm_t["fc1_768x3072/M8/float32"]
    kernels = [
        record("ragged_paged_attention",
               "paddle_tpu_torch/ops/csrc/paged_attention.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:520",
               e2e["attention_cuda"], dec,
               bf16_max_abs_err=native_t["bf16_max_abs_err"]),
        record("ragged_paged_attention_int8",
               "paddle_tpu_torch/ops/csrc/paged_attention.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:461",
               st["attention_cuda_int8"], idec, fused_dequant=1,
               settings={k: v for k, v in int8_t.items()
                         if "fused_dequant=" in k},
               nan_scale_ok=int8_t["nan_scale_ok"],
               bf16_max_abs_err=int8_t["bf16_max_abs_err"]),
        record("quantized_matmul",
               "paddle_tpu_torch/ops/csrc/quantized_matmul.cu",
               "paddle_tpu/ops/pallas_ops/quantized_matmul.py:104",
               st["qmm_cuda"], qdec, case="fc1_768x3072/M8/float32",
               cases=qmm_t),
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**report, "kernels": kernels}, f, indent=1,
                      default=str)
    print(card)
    print(json.dumps({"kernels": kernels}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
