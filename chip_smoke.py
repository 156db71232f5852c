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
8. kernel_flash: the flash attention forward, dK/dV and dQ kernels
   against their plain versions in f32 and bf16 (the bf16 forward and
   dK/dV on the tensor cores, their launches logged) at the training
   shape (B 8, H 12, S 1024, D 64, causal), a BERT-base shape (S 512,
   non-causal, padded kv mask, dropout 0.1) and unaligned S 1000 with
   D 80, 100 and 256; the dropout bits of all three kernels in f32 and
   in bf16 read back and compared with ``_keep_mask`` bit for bit; each
   kernel timed at the training shape beside its bound, its plain
   version and PyTorch's ``scaled_dot_product_attention`` (forward; its
   autograd backward for the pair).
9. train: GPT-2-small widths, all 12 layers, f32 with TF32 off, seeded
   weights, ``AdamW(6e-4, weight_decay=0.1)`` on one seeded B 8 x S 1024
   batch: a warm-up step, then 5 steps of ``loss.backward(); opt.step();
   opt.clear_grad()``.  Every loss finite, the first within 0.5 of
   ln(vocab), the loss falling; every attention call on the flash
   kernels (12 x 5 launches of each, the plain and sdpa routes 0); one
   more step under ``torch.profiler`` gives the device time by kernel
   family and the device's busy share.
10. train_parity: 2 layers at the same widths, B 2 x S 1024: one step's
   loss and every gradient on the card against the same step on the CPU
   through the plain flash route, then the weights after one AdamW step.
11. kernel_decode: the per-row paged attention kernel (one table row and
   one length per query row) and its int8 body against their plain
   version, f32 (and once bf16), at the test shapes, GPT-2-small decode
   rows and a GPT-2-small prefill chunk (64 rows of one sequence sharing
   its table row), both ``fused_dequant`` settings and a NaN scale row;
   timed beside its bound, the plain version, SDPA over the gathered
   dense KV and the ragged kernel at one row per lane on the same inputs.
12. e2e_split: the requests of phase 5 through the split programs —
   ``ragged=False`` pipelined and synchronous, ``fused_steps=4``, and
   ``ragged=False`` with int8 KV and weights and phase 6's export; every
   attention call on the per-row kernel, no page leaked, every stream
   equal to ``generate`` (``generate(quant=export)``) except at a
   reported near-tie.
13. e2e_spec: prompts with repeated spans, ``spec_decode=4`` on the
   default ragged engine (verify folded into the ragged kernel), on
   ``ragged=False`` (the split verify on the per-row kernel) and on the
   ragged engine with uncalibrated int8 KV (the sequential split verify
   and its rollback on the int8 per-row body); every stream equal to the
   same engine's with speculation off except at a reported near-tie,
   drafts proposed, launches counted per route.
14. kernel_stats: the stats form of the ragged kernel (a sequence shard's
   attention over the pages it owns, returning the context and its
   log-sum-exp) and its int8 body in both ``fused_dequant`` settings
   against their plain version, f32 and bf16, at GPT-2-small shard
   shapes (H 12 and 6, D 64, page 16, 64 pages a lane; 8 decode lanes,
   8 lanes of 64 prefill rows), every second page owned, a lane that
   owns nothing and an empty lane (zeros, lse -1e30), NaN K scales on an
   owned page (exactly its readers) and an unowned one (nobody); timed
   beside its bound over the owned pages, the plain version, the
   memory-efficient SDPA kernel with its log-sum-exp on the gathered
   owned KV, and the ragged kernel over all pages.
15. e2e_mesh: ``force_device_count(4)``, then ``mesh_axes={"tp": 2,
   "sp": 2}`` at GPT-2-small width on 4 long prompts (600-990 tokens, 32
   new tokens) in a 260-page pool, native and with int8 KV and weights
   (phase 6's export), and ``spec_decode=4`` at ``{"tp": 2}``; each
   against the single-device engine with the same knobs, at most one
   recorded near-tie; the stats kernel (the ragged one at sp 1) launched
   once per layer, shard and dispatch, one shard step per dispatch, a
   sequence on both page shards, no page leaked.  Its step times are 4
   (or 2) slots on one card: the replicated work runs once per slot.
16. kernel_scale_shift: row t, the custom-op API's worked kernel
   ``x * scale[0] + shift[0]``, against its plain version bit for bit in
   f32 and bf16 at [16, 8] (the custom-op net), [4, 8], 1,000,003 and
   [8192, 8192], no launch at numel 0; timed at [16, 8] and [8192, 8192]
   beside its bound, the plain version and ``torch.addcmul``.
17. custom_op: ``register_op("scale_shift", ..., vjp=...)`` in
   ``tests/test_custom_op.py``'s eager net (Linear 8-8, the scale-shift
   layer, Linear 8-1), 15 ``Adam(5e-2)`` steps on the card from the
   weights of the same net built on the CPU under ``seed(0)``: 30 kernel
   launches (forward and dx each step), no plain call, the loss halves,
   the losses equal the CPU's.
18. lenet: dygraph LeNet on the synthetic MNIST, ``Adam(1e-3)``, 30
   in-order batches of 64, f32: the loss falls, the first 5 losses equal
   the CPU's from the same weights; step p50 / p95 and images/s.
19. train_bf16: phase 9 with the forward under
   ``amp.auto_cast(dtype="bfloat16")``, as ``bench.py`` trains GPT (the
   loss in f32; master weights, gradients and AdamW state f32): 12 x 5
   launches of each flash kernel, the forward and dK/dV of them on the
   tensor cores; the same loss checks, step times, peak memory and
   device time by kernel family.
20. train_parity_bf16: phase 10 under the same autocast (2 layers, B 2 x
   S 1024): the loss and every gradient against the CPU's plain route
   at bf16 tolerances, and the card's AdamW step against the same step
   replayed on the CPU from the card's gradients.

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


# the per-row kernel's cases: the test width, GPT-2-small decode rows
# (one table row each) and a GPT-2-small prefill chunk: 64 rows of one
# sequence at positions 448..511 sharing its table row, the tail padded
# past the prompt's 500 positions
DECODE_CASES = [
    ("test", dict(H=2, D=16, P=4, M=5, lens=[0, 1, 7, 19, 20])),
    ("gpt2_decode", dict(H=12, D=64, P=16, M=64,
                         lens=[0, 1, 17, 100, 255, 512, 777, 1024])),
    ("gpt2_chunk", dict(H=12, D=64, P=16, M=64, chunk=(448, 64, 500)))]
DECODE_TIMED = ("gpt2_decode", "gpt2_chunk")


def make_rows(rng, *, H, D, P, M, lens=None, chunk=None,
              dtype=torch.float32):
    """Per-row inputs: q [B, H, D], random pools (trash page 0 included),
    one table row and one length per row.  ``lens``: one sequence per
    row with distinct pages; ``chunk=(off, C, valid)``: C rows of one
    sequence sharing its table row, row r seeing min(off + r + 1, valid)
    positions."""
    if chunk is not None:
        off, C, valid = chunk
        seq_lens = np.minimum(off + np.arange(C) + 1, valid)
        seqs = [valid]
    else:
        seq_lens = np.asarray(lens)
        seqs = list(lens)
    need = [-(-min(n, M * P) // P) for n in seqs]
    N = 1 + sum(need) + 3
    perm = rng.permutation(np.arange(1, N))
    pt = np.zeros((len(seqs), M), np.int32)
    at = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[at:at + n]
        at += n
    if chunk is not None:
        pt = np.repeat(pt, len(seq_lens), axis=0)
    B = len(seq_lens)
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
    kp = torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(N, P, H, D).astype(np.float32))
    return (q.to(DEVICE, dtype), kp.to(DEVICE, dtype), vp.to(DEVICE, dtype),
            torch.from_numpy(pt).to(DEVICE),
            torch.from_numpy(seq_lens.astype(np.int32)).to(DEVICE))


def rows_bound_ms(q, k_pages, page_tables, seq_lens):
    """Least time for a per-row call on an H100: the larger of its bytes
    (q and out once; each distinct (page, slot) some row reads below its
    length once, K and V — rows sharing a table row read the same
    positions — with int8 pools each distinct page's two [H] f32 scale
    rows; the lengths and the used table entries) over HBM bandwidth,
    and its f32 flops (4*D per visible position, row and head) over the
    f32 CUDA-core peak."""
    B, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    pt = page_tables.cpu().numpy()
    lens = seq_lens.clamp(max=M * P).cpu().numpy().astype(np.int64)
    slots, pages = set(), set()
    for b in range(B):
        for j in range(-(-int(lens[b]) // P)):
            n = min(P, int(lens[b]) - j * P)
            slots.update((int(pt[b, j]), s) for s in range(n))
            pages.add(int(pt[b, j]))
    kv_bytes = len(slots) * H * D * k_pages.element_size() * 2
    if k_pages.dtype == torch.int8:
        kv_bytes += len(pages) * H * 4 * 2
    table_bytes = int(sum(-(-int(n) // P) for n in lens)) * 4
    io_bytes = 2 * q.numel() * q.element_size() + B * 4
    t_bytes = (kv_bytes + table_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = int(lens.sum()) * H * D * 4 / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _decode_timings(pa, tag, args, kernel, plain, err, flush):
    """One timed case of the per-row kernel: its time beside its bound,
    the plain version, SDPA over each row's gathered dense KV, and the
    ragged kernel on the same inputs at one row per lane (and, for a
    shared table row, as one lane of B rows)."""
    q, kp, vp, pt, sl = args[:5]
    scales = args[5:]
    if scales:
        kd = kp.float() * scales[0][:, None, :, None]
        vd = vp.float() * scales[1][:, None, :, None]
    else:
        kd, vd = kp, vp
    q_d, k_d, v_d, mask = sdpa_inputs(q[:, None], kd, vd, pt, sl[:, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = {"max_abs_err": err, "ms": time_ms(kernel, flush),
         "plain_ms": time_ms(plain, flush),
         "library_ms": time_ms(lambda: sdpa(q_d, k_d, v_d, attn_mask=mask),
                               flush),
         "ragged_qb1_ms": time_ms(
             lambda: pa.ragged_paged_attention_cuda(
                 q[:, None], kp, vp, pt, sl[:, None], *scales), flush)}
    if bool((pt == pt[:1]).all()):
        t["ragged_one_lane_ms"] = time_ms(
            lambda: pa.ragged_paged_attention_cuda(
                q[None], kp, vp, pt[:1], sl[None], *scales), flush)
    t["bound_ms"], t["bound_by"] = rows_bound_ms(q, kp, pt, sl)
    log("kernel_decode_time", case=tag, **t)
    return t


def decode_kernel_phase(rng, flush) -> dict:
    """Bodies #2 and #2q against their plain version: f32 at every case
    (#2q in both fused_dequant settings), bf16 once at decode, NaN scale
    rows at decode and in the chunk; then the timed cases."""
    from paddle_tpu_torch.ops import paged_attention as pa

    checked = {}
    for name, kw in DECODE_CASES:
        dtypes = ((torch.float32, torch.bfloat16) if name == "gpt2_decode"
                  else (torch.float32,))
        for dtype in dtypes:
            args = make_rows(rng, dtype=dtype, **kw)
            dt = str(dtype).split(".")[-1]
            ref = pa.paged_attention_ref(
                *(a.float() if a.is_floating_point() else a for a in args))
            out = pa.paged_attention_cuda(*args)
            torch.cuda.synchronize()
            tag = f"{name}/{dt}"
            checked[tag] = (args, _check_close(
                "kernel_decode", tag, out, ref, args[4], KERNEL_TOL[dtype]))
            q, kq, vq, ks, vs = (args[0],) + quantize_pools(*args[1:3])
            iargs = (q, kq, vq, args[3], args[4], ks, vs)
            ref = pa.paged_attention_ref(q.float(), *iargs[1:])
            for fused in (1, 0):
                out = pa.paged_attention_cuda(*iargs, fused_dequant=fused)
                torch.cuda.synchronize()
                itag = f"{tag}/int8/fused_dequant={fused}"
                checked[itag] = (iargs, _check_close(
                    "kernel_decode", itag, out, ref, args[4],
                    KERNEL_TOL[dtype]))

    # a NaN in one K scale row: non-finite exactly on the rows that read
    # that page below their length — decode row 5 (length 512) reads its
    # page 3; chunk rows read page 30 (positions 480..495) from row 32 on
    nan_ok = {}
    for name, pick, readers in (
            ("gpt2_decode", lambda pt: int(pt[5, 3]), lambda sl: (
                torch.arange(len(sl), device=sl.device) == 5)),
            ("gpt2_chunk", lambda pt: int(pt[0, 30]), lambda sl: sl > 480)):
        for fused in (1, 0):
            args = list(checked[f"{name}/float32/int8/fused_dequant="
                                f"{fused}"][0])
            ks = args[5].clone()
            head = 7
            ks[pick(args[3]), head] = float("nan")
            args[5] = ks
            out = pa.paged_attention_cuda(*args, fused_dequant=fused)
            ref = pa.paged_attention_ref(*args)
            torch.cuda.synchronize()
            bad = ~torch.isfinite(out).all(dim=-1)             # [B, H]
            want = torch.zeros_like(bad)
            want[:, head] = readers(args[4])
            fin = ~bad[..., None].expand_as(out)
            err = float((out[fin] - ref[fin]).abs().max())
            ok = (bool(want.any()) and torch.equal(bad, want)
                  and torch.equal(~torch.isfinite(ref).all(dim=-1), want)
                  and err <= KERNEL_TOL[torch.float32])
            log("kernel_decode", case=f"{name}/nan_k_scale",
                fused_dequant=fused, non_finite_rows=int(bad.sum()),
                readers=int(want.sum()), max_abs_err_elsewhere=err, ok=ok)
            if not ok:
                raise AssertionError(
                    f"NaN k_scale ({name}, fused_dequant={fused}): "
                    f"non-finite at {bad.nonzero().tolist()}, expected "
                    f"{want.nonzero().tolist()}; error elsewhere {err}")
            nan_ok[f"{name}/fused_dequant={fused}"] = ok

    timings = {"nan_scale_ok": all(nan_ok.values()),
               "bf16_max_abs_err": checked["gpt2_decode/bfloat16"][1],
               "int8_bf16_max_abs_err": max(
                   checked[f"gpt2_decode/bfloat16/int8/fused_dequant={f}"][1]
                   for f in (1, 0))}
    for name in DECODE_TIMED:
        tag = f"{name}/float32"
        args, err = checked[tag]
        timings[tag] = _decode_timings(
            pa, tag, args, lambda: pa.paged_attention_cuda(*args),
            lambda: pa.paged_attention_ref(*args), err, flush)
        for fused in (1, 0):
            itag = f"{tag}/int8/fused_dequant={fused}"
            iargs, err = checked[itag]
            timings[itag] = _decode_timings(
                pa, itag, iargs,
                lambda: pa.paged_attention_cuda(*iargs,
                                                fused_dequant=fused),
                lambda: pa.paged_attention_ref(*iargs), err, flush)
    return timings


# the stats form's cases (a sequence shard of the serving mesh): GPT-2-small
# shard shapes — H 6 (12 heads at tp 2) and 12 — decode 8 lanes x 1 row,
# prefill 8 lanes x 64 rows; every second table entry owned, lane 2 owns
# nothing, lane 0 is empty
STATS_CASES = [
    (f"{kind}_h{H}", dict(G=8, Qb=Qb, H=H, D=64, P=16, M=64,
                          lane_lens=lens, row_gaps=gaps))
    for H in (12, 6)
    for kind, Qb, lens, gaps in (
        ("decode", 1, [0, 1, 300, 100, 255, 512, 777, 1024], None),
        ("prefill", 64, [0, 63, 400, 250, 401, 600, 900, 1024],
         {1: range(40, 64), 3: [5, 6, 7]}))]
STATS_TIMED = ("decode_h12", "prefill_h12")
# the stats kernel vs its plain version: o within 1e-6 in f32 (the same
# f32 products over at most 512 owned positions in another order; the
# int8 body scales after the dot where the plain version dequantizes
# before it) and 2e-2 in bf16 (the kernel rounds o to bf16), both times
# max(1, the largest reference value); lse within 1e-5
STATS_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5
STATS_NO_OWNER = 2


def stats_page_ok(page_tables):
    """Every second table entry owned; lane STATS_NO_OWNER owns none."""
    ok = (torch.arange(page_tables.shape[1], device=page_tables.device)
          % 2 == 0).to(torch.int32)[None, :].repeat(page_tables.shape[0], 1)
    ok[STATS_NO_OWNER] = 0
    return ok.contiguous()


def stats_bound_ms(q, k_pages, page_tables, row_lens, page_ok):
    """Least time for a stats call on an H100: the larger of its bytes (q
    and o once, lse, each lane's K and V positions below its horizon on
    OWNED pages once — with int8 pools each such page's two [H] f32
    scale rows — the row lengths, the table and ownership entries) over
    HBM bandwidth, and its f32 flops (4*D per visible position, row and
    head) over the f32 CUDA-core peak."""
    G, Qb, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    rl = row_lens.clamp(max=M * P).cpu().numpy().astype(np.int64)
    ok = page_ok.cpu().numpy() != 0
    pos_owned = np.repeat(ok, P, axis=1)                      # [G, M*P]
    horizon = rl.max(axis=1)
    below = np.arange(M * P)[None, :] < horizon[:, None]
    positions = int((pos_owned & below).sum())
    pages = int(sum(ok[g, :-(-int(h) // P)].sum() for g, h in
                    enumerate(horizon)))
    kv_bytes = positions * H * D * k_pages.element_size() * 2
    if k_pages.dtype == torch.int8:
        kv_bytes += pages * H * 4 * 2
    io_bytes = (2 * q.numel() * q.element_size() + G * Qb * H * 4
                + row_lens.numel() * 4 + 2 * int(sum(
                    -(-int(h) // P) for h in horizon)) * 4)
    visible = int(sum(((np.arange(M * P)[None, :] < rl[g][:, None])
                       & pos_owned[g][None, :]).sum() for g in range(G)))
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = visible * H * D * 4 / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def stats_library_inputs(q, k_pages, v_pages, page_tables, row_lens,
                         page_ok):
    """The yardstick's inputs: each lane's owned pages (the even table
    entries) gathered into dense [G, H, S, D] K/V, and an additive
    [G, H, Qb, S] bias hiding the positions a row does not see."""
    G, Qb, H, D = q.shape
    P = k_pages.shape[1]
    idx = page_tables[:, ::2].long()
    S = idx.shape[1] * P
    k = k_pages[idx].reshape(G, S, H, D).transpose(1, 2).contiguous()
    v = v_pages[idx].reshape(G, S, H, D).transpose(1, 2).contiguous()
    pos = (torch.arange(idx.shape[1], device=q.device)[:, None] * 2 * P
           + torch.arange(P, device=q.device)[None, :]).reshape(-1)
    own = page_ok[:, ::2].repeat_interleave(P, dim=1) != 0      # [G, S]
    see = (pos[None, None, :] < row_lens.long()[:, :, None]) \
        & own[:, None, :]                                       # [G, Qb, S]
    bias = torch.where(see, 0.0, -1e30).to(q.dtype)[:, None].expand(
        G, H, Qb, S).contiguous()
    return q.transpose(1, 2).contiguous(), k, v, bias


def _check_stats(tag, o, lse, ref_o, ref_lse, row_lens, page_ok, tol,
                 **extra):
    err = float((o.float() - ref_o.float()).abs().max())
    limit = tol * max(1.0, float(ref_o.abs().max()))
    lse_err = float((lse - ref_lse).abs().max())
    empty = (row_lens == 0) | ~(page_ok != 0).any(dim=1)[:, None]
    zeros_exact = bool((o[empty] == 0).all())
    neg_inf = bool((lse[empty] == -1e30).all())
    ok = (math.isfinite(err) and err <= limit and lse_err <= LSE_TOL
          and zeros_exact and neg_inf and bool(empty.any()))
    log("kernel_stats", case=tag, max_abs_err=err, lse_max_abs_err=lse_err,
        limit=limit, lse_tol=LSE_TOL, empty_rows=int(empty.sum()),
        empty_rows_exact_zero=zeros_exact, empty_rows_lse_neg_inf=neg_inf,
        ok=ok, **extra)
    if not ok:
        raise AssertionError(
            f"kernel_stats: the stats kernel disagrees with its plain "
            f"version on {tag} {extra}: o err {err} (limit {limit}), lse err "
            f"{lse_err} (tol {LSE_TOL}), empty rows zero {zeros_exact}, "
            f"lse -1e30 {neg_inf}")
    return err


def stats_kernel_phase(rng, flush) -> dict:
    """Bodies #3 and #3q against their plain version: f32 and bf16 at
    every case, #3q in both fused_dequant settings, NaN K scale rows on an
    owned and on an unowned page; then the timed cases beside their
    bound, the plain version and the memory-efficient SDPA kernel with
    its log-sum-exp on the gathered owned KV."""
    from paddle_tpu_torch.ops import paged_attention as pa

    checked = {}
    for name, kw in STATS_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, pt, rl = make_case(rng, dtype=dtype, **kw)
            ok = stats_page_ok(pt)
            dt = str(dtype).split(".")[-1]
            args = (q, kp, vp, pt, rl, ok)
            o, lse = pa.ragged_paged_attention_stats_cuda(*args)
            torch.cuda.synchronize()
            ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(
                *(a.float() if a.is_floating_point() else a for a in args))
            tag = f"{name}/{dt}"
            checked[tag] = (args, _check_stats(tag, o, lse, ref_o, ref_lse,
                                               rl, ok, STATS_TOL[dtype]))
            kq, vq, ks, vs = quantize_pools(kp, vp)
            iargs = (q, kq, vq, pt, rl, ok, ks, vs)
            ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(
                q.float(), *iargs[1:])
            for fused in (1, 0):
                o, lse = pa.ragged_paged_attention_stats_cuda(
                    *iargs, fused_dequant=fused)
                torch.cuda.synchronize()
                itag = f"{tag}/int8/fused_dequant={fused}"
                checked[itag] = (iargs, _check_stats(
                    itag, o, lse, ref_o, ref_lse, rl, ok, STATS_TOL[dtype]))

    # NaN K scale rows: on lane 4's owned entry 2 (positions 32..47) the
    # NaN reaches exactly the rows that read it; on its unowned entry 3
    # nobody (the kernel never reads a page its shard does not own)
    nan_ok = {}
    for name in ("decode_h12", "prefill_h12"):
        for fused in (1, 0):
            args = list(checked[f"{name}/float32/int8/fused_dequant="
                                f"{fused}"][0])
            pt, rl = args[3], args[4]
            ks = args[6].clone()
            head = 7
            ks[int(pt[4, 2]), head] = float("nan")
            ks[int(pt[4, 3]), head + 1] = float("nan")
            args[6] = ks
            o, lse = pa.ragged_paged_attention_stats_cuda(
                *args, fused_dequant=fused)
            ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(*args)
            torch.cuda.synchronize()
            bad = ~torch.isfinite(o).all(dim=-1)               # [G, Qb, H]
            want = torch.zeros_like(bad)
            want[4, :, head] = rl[4] > 32
            fin = ~bad[..., None].expand_as(o)
            err = float((o[fin] - ref_o[fin]).abs().max())
            limit = STATS_TOL[torch.float32] * max(
                1.0, float(ref_o[fin].abs().max()))
            good = (bool(want.any()) and torch.equal(bad, want)
                    and torch.equal(~torch.isfinite(ref_o).all(dim=-1), want)
                    and err <= limit)
            log("kernel_stats", case=f"{name}/nan_k_scale",
                fused_dequant=fused, non_finite_rows=int(bad.sum()),
                readers=int(want.sum()), max_abs_err_elsewhere=err, ok=good)
            if not good:
                raise AssertionError(
                    f"NaN k_scale ({name}, fused_dequant={fused}): "
                    f"non-finite at {bad.nonzero().tolist()}, expected "
                    f"{want.nonzero().tolist()}; error elsewhere {err}")
            nan_ok[f"{name}/fused_dequant={fused}"] = good

    efficient = torch.ops.aten._scaled_dot_product_efficient_attention
    timings = {"nan_scale_ok": all(nan_ok.values()),
               "bf16_max_abs_err": max(v[1] for k, v in checked.items()
                                       if "bfloat16" in k
                                       and "int8" not in k),
               "int8_bf16_max_abs_err": max(v[1] for k, v in checked.items()
                                            if "bfloat16/int8" in k),
               "max_abs_err_by_case": {k: v[1] for k, v in checked.items()}}
    for name in STATS_TIMED:
        for tag in (f"{name}/float32", f"{name}/float32/int8/fused_dequant=1",
                    f"{name}/float32/int8/fused_dequant=0"):
            args, err = checked[tag]
            fused = 0 if tag.endswith("=0") else 1
            q, kp, vp, pt, rl, ok = args[:6]
            scales = args[6:]
            if scales:
                kd = kp.float() * scales[0][:, None, :, None]
                vd = vp.float() * scales[1][:, None, :, None]
            else:
                kd, vd = kp, vp
            lq, lk, lv, bias = stats_library_inputs(q, kd, vd, pt, rl, ok)
            t = {"max_abs_err": err,
                 "ms": time_ms(lambda: pa.ragged_paged_attention_stats_cuda(
                     *args, fused_dequant=fused), flush),
                 "plain_ms": time_ms(
                     lambda: pa.ragged_paged_attention_stats_ref(*args),
                     flush),
                 "library_ms": time_ms(
                     lambda: efficient(lq, lk, lv, bias, True), flush),
                 "ragged_all_pages_ms": time_ms(
                     lambda: pa.ragged_paged_attention_cuda(
                         q, kp, vp, pt, rl, *scales), flush)}
            t["bound_ms"], t["bound_by"] = stats_bound_ms(q, kp, pt, rl, ok)
            # ownership in runs, as the allocator hands a shard its pages:
            # each lane owns the first half of its table, so whole 32-
            # position tiles go unread (with every second 16-slot page
            # owned, every tile holds an owned position)
            runs = (torch.arange(pt.shape[1], device=pt.device)[None, :]
                    < pt.shape[1] // 2).to(torch.int32).repeat(
                        pt.shape[0], 1).contiguous()
            rargs = (q, kp, vp, pt, rl, runs) + tuple(scales)
            t["owned_runs_ms"] = time_ms(
                lambda: pa.ragged_paged_attention_stats_cuda(
                    *rargs, fused_dequant=fused), flush)
            t["owned_runs_bound_ms"] = stats_bound_ms(q, kp, pt, rl,
                                                      runs)[0]
            log("kernel_stats_time", case=tag, **t)
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


def flash_keep_bits(kv_mask, H, S, D, seed, dropout_p,
                    dtype=torch.float32):
    """The dropout keep bits each flash kernel of ``dtype`` applied, read
    back exactly: ``{"fwd", "dkv", "dq"}`` -> bool ``[B·H, S, S]`` (row,
    col).

    With q = 0 every visible score is 0, so each probability is 1/n over
    a row's n visible keys (the backward kernels get lse = log n).  A
    one-hot operand then copies column ``c0 + d`` of the dropped
    probabilities into output column ``d``, which is > 0 exactly where
    the bit is kept: v for the forward (o = P'v), dO for dK/dV (dV =
    P'ᵀdO, read transposed) and k for dQ (with dO = v = e0 and delta 0,
    dQ = dS·k and dS = P'·1).  Masked keys read as dropped.  On the card,
    not causal.  In bf16 (the forward and dK/dV on the tensor cores) a
    kept probability 1/(n (1 - p)) stays > 0 after its rounding to bf16,
    so the bits read back as exactly."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B = kv_mask.shape[0]
    dev = kv_mask.device
    mask = kv_mask.float().contiguous()
    n = mask.sum(dim=-1)                                        # [B]
    lse = torch.log(n)[:, None, None].expand(B, H, S).reshape(
        B * H, S, 1).contiguous()
    zero_rows = torch.zeros(B * H, S, 1, device=dev)
    zeros = torch.zeros(B, H, S, D, device=dev, dtype=dtype)
    e0 = zeros.clone()
    e0[..., 0] = 1.0
    bits = {name: torch.zeros(B * H, S, S, dtype=torch.bool, device=dev)
            for name in ("fwd", "dkv", "dq")}
    for c0 in range(0, S, D):
        w = min(D, S - c0)
        onehot = zeros.clone()
        onehot[:, :, c0:c0 + w, :w] = torch.eye(w, device=dev, dtype=dtype)
        o, _ = fa.flash_fwd_cuda(zeros, zeros, onehot, mask, seed, 1.0,
                                 False, dropout_p)
        bits["fwd"][:, :, c0:c0 + w] = o.reshape(B * H, S, D)[..., :w] > 0
        _, dv = fa.flash_dkv_cuda(zeros, zeros, zeros, onehot, lse,
                                  zero_rows, mask, seed, 1.0, False,
                                  dropout_p)
        bits["dkv"][:, c0:c0 + w, :] = (
            dv.reshape(B * H, S, D)[..., :w] > 0).transpose(1, 2)
        dq = fa.flash_dq_cuda(zeros, onehot, e0, e0, lse, zero_rows, mask,
                              seed, 1.0, False, dropout_p)
        bits["dq"][:, :, c0:c0 + w] = dq.reshape(B * H, S, D)[..., :w] > 0
    return bits


def flash_keep_reference(kv_mask, H, S, seed, dropout_p):
    """``_keep_mask``'s bits for every (b·h, row, col), masked keys
    dropped: what :func:`flash_keep_bits` must read back."""
    from paddle_tpu_torch.ops.flash_attention import _keep_mask

    B = kv_mask.shape[0]
    dev = kv_mask.device
    bh = torch.arange(B * H, device=dev)[:, None, None]
    idx = torch.arange(S, device=dev)
    keep = _keep_mask(seed, bh, idx[:, None], idx[None, :], dropout_p)
    valid = (kv_mask > 0).repeat_interleave(H, dim=0)[:, None, :]
    return keep & valid


# flash kernels vs their plain versions: f32 sums over up to 1024 keys
# or queries in another order (1e-4); bf16 outputs rounded to 8 mantissa
# bits (2e-2) — both times max(1, the largest reference value)
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 outputs also in relative L2 norm over the whole tensor
# (flash_rel_l2), where the long causal rows (small |o| under a max-abs
# limit set by row 0's |v|) cannot hide: the bf16 roundings of P, dS and
# the outputs, 2^-9 relative each, land at 1.8e-3 to 2.8e-3 in the CPU
# emulation of the tensor-core bodies against the Pallas kernels, where a
# body that drops one 64-key tile of the rows past 300 at S 1024 lands at
# 0.18 (tests/test_torch_flash_tc_numerics.py).  f32's max-abs 1e-4 is
# already far below what a dropped tile costs
FLASH_REL_L2 = {torch.bfloat16: 1e-2}
# the rms that stands in for the reference's where that is smaller: a
# gradient whose exact value is 0 (dk and dq at a single key) is rounding
# noise in both versions; every other reference of the card tests has an
# rms of at least 0.05
FLASH_REL_L2_FLOOR = 1e-2
BF16_FLOPS_PER_S = 989e12
# (name, B, H, S, D, causal, kv mask with padded tails, dropout_p):
# (a) the training shape, (b) a BERT-base shape, (c) unaligned S and D
# (D 100: bf16 rows not a multiple of 16 bytes, loaded element by element)
FLASH_CASES = [("train", 8, 12, 1024, 64, True, False, 0.0),
               ("bert", 8, 12, 512, 64, False, True, 0.1),
               ("unaligned_d80", 2, 4, 1000, 80, True, True, 0.1),
               ("unaligned_d100", 2, 4, 1000, 100, True, True, 0.1),
               ("unaligned_d256", 2, 4, 1000, 256, True, True, 0.1)]
FLASH_SEED = 20240611
FLASH_TIMED = "train"
# the bf16 forward and dK/dV bodies (namespace tc of flash_attention.cu)
FLASH_TC_DESIGN = ("mma.sync m16n8k16 bf16 with f32 accumulators; cp.async "
                   "ring of 3 stages; ldmatrix (.trans) from XOR-swizzled "
                   "tiles; P and dS rounded to bf16 in registers")


def flash_inputs(rng, B, H, S, D, masked, dtype):
    q, k, v, g = (torch.from_numpy(rng.randn(B, H, S, D).astype(
        np.float32)).to(DEVICE, dtype) for _ in range(4))
    mask = torch.ones(B, S)
    if masked:
        for b in range(B):
            mask[b, rng.randint(S // 2, S + 1):] = 0.0
    return q, k, v, g, mask.to(DEVICE)


def flash_bound_ms(kernel, B, H, S, D, causal, item):
    """Least time on an H100 for one kernel call: the larger of its bytes
    (each input read once, each output written once) over 3.35 TB/s and
    its operations over the peak of the input type (67 TFLOP/s f32,
    989 TFLOP/s bf16).  Operations, the standard accounting: the forward
    is 4·B·H·S²·D (its two products, 2·S²·D each), the backward pair
    2.5× the forward — its five products, of which dK/dV owns three
    (S = QKᵀ, dV, dK: 1.5× the forward) and dQ two (dP, dQ: 1.0×); the
    products each backward kernel recomputes for itself are not counted
    twice.  Causal halves every count."""
    tensor = B * H * S * D * item
    rows = B * H * S * 4                         # lse or delta, f32
    mask = B * S * 4
    fwd_ops = 4.0 * B * H * S * S * D * (0.5 if causal else 1.0)
    nbytes, ops = {"fwd": (4 * tensor + rows + mask, fwd_ops),
                   "dkv": (6 * tensor + 2 * rows + mask, 1.5 * fwd_ops),
                   "dq": (5 * tensor + 2 * rows + mask, 1.0 * fwd_ops)}[
        kernel]
    peak = F32_FLOPS_PER_S if item == 4 else BF16_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_rel_l2(got, want) -> float:
    """‖got − want‖₂ / ‖want‖₂ over the whole tensor, with an rms of
    FLASH_REL_L2_FLOOR standing in for ``want``'s where that is
    smaller."""
    want = want.float()
    floor = FLASH_REL_L2_FLOOR * math.sqrt(want.numel())
    return float((got.float() - want).norm()) / max(float(want.norm()),
                                                    floor)


def _flash_check(tag, name, got, want, tol, rel_l2=None):
    want = want.float()
    err = float((got.float() - want).abs().max())
    limit = tol * max(1.0, float(want.abs().max()))
    rel = flash_rel_l2(got, want) if rel_l2 is not None else None
    ok = (math.isfinite(err) and err <= limit
          and (rel is None or rel <= rel_l2))
    log("kernel_flash", case=tag, output=name, max_abs_err=err, limit=limit,
        rel_l2=rel, rel_l2_limit=rel_l2, ok=ok)
    if not ok:
        raise AssertionError(f"flash {name} kernel disagrees with its plain "
                             f"version on {tag}: max_abs_err {err} (limit "
                             f"{limit}), relative L2 {rel} (limit {rel_l2})")
    return err


def flash_kernel_phase(rng, flush) -> dict:
    """Bodies #5, #6 and #7 against their plain versions on the card in
    f32 and bf16 at FLASH_CASES, the dropout bits of all three read back
    exactly at the BERT shape, and each kernel timed at the training
    shape beside its bound, its plain version and PyTorch's SDPA
    (forward; its autograd backward for the pair)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    errs, timings = {}, {}
    reset_flash_counts()
    for name, B, H, S, D, causal, masked, p in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            q, k, v, g, mask = flash_inputs(rng, B, H, S, D, masked, dtype)
            scale = 1.0 / math.sqrt(D)
            qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
            common = (mask, FLASH_SEED, scale, causal, p)
            ref_o, ref_lse = fa.flash_fwd_ref(qf, kf, vf, *common)
            delta = (gf * ref_o).sum(-1).reshape(B * H, S, 1)
            o, lse = fa.flash_fwd_cuda(q, k, v, *common)
            bwd = (ref_lse, delta) + common
            dk, dv = fa.flash_dkv_cuda(q, k, v, g, *bwd)
            dq = fa.flash_dq_cuda(q, k, v, g, *bwd)
            torch.cuda.synchronize()
            rdk, rdv = fa.flash_dkv_ref(qf, kf, vf, gf, *bwd)
            rdq = fa.flash_dq_ref(qf, kf, vf, gf, *bwd)
            tol, rel = FLASH_TOL[dtype], FLASH_REL_L2.get(dtype)
            errs[tag] = {
                "fwd": max(_flash_check(tag, "o", o, ref_o, tol, rel),
                           _flash_check(tag, "lse", lse, ref_lse, 1e-4)),
                "dkv": max(_flash_check(tag, "dk", dk, rdk, tol, rel),
                           _flash_check(tag, "dv", dv, rdv, tol, rel)),
                "dq": _flash_check(tag, "dq", dq, rdq, tol, rel)}
            del ref_o, rdk, rdv, rdq
            if name != FLASH_TIMED:
                continue
            item = q.element_size()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            ql, kl, vl = (t.detach().clone().requires_grad_(True)
                          for t in (q, k, v))
            lib_out = sdpa(ql, kl, vl, is_causal=causal)
            lib_err = float((lib_out.detach().float() - o.float())
                            .abs().max())
            calls = {
                "fwd": (lambda: fa.flash_fwd_cuda(q, k, v, *common),
                        lambda: fa.flash_fwd_ref(q, k, v, *common),
                        lambda: sdpa(q, k, v, is_causal=causal)),
                "dkv": (lambda: fa.flash_dkv_cuda(q, k, v, g, *bwd),
                        lambda: fa.flash_dkv_ref(q, k, v, g, *bwd),
                        lambda: torch.autograd.grad(
                            lib_out, (ql, kl, vl), g, retain_graph=True)),
                "dq": (lambda: fa.flash_dq_cuda(q, k, v, g, *bwd),
                       lambda: fa.flash_dq_ref(q, k, v, g, *bwd), None)}
            for kname, (kern, plain, lib) in calls.items():
                t = {"max_abs_err": errs[tag][kname],
                     "ms": time_ms(kern, flush),
                     "plain_ms": time_ms(plain, flush),
                     "library_ms": (time_ms(lib, flush) if lib is not None
                                    else None)}
                t["bound_ms"], t["bound_by"] = flash_bound_ms(
                    kname, B, H, S, D, causal, item)
                if kname == "fwd":
                    t["library_max_abs_err"] = lib_err
                if kname == "dkv":
                    # SDPA's autograd backward computes dq, dk and dv in
                    # one call: it is the yardstick of the pair
                    t["library_is"] = "sdpa backward (dq, dk, dv)"
                log("kernel_flash_time", case=tag, kernel=kname, **t)
                timings[f"{kname}/{tag}"] = t
            del ql, kl, vl, lib_out
            torch.cuda.empty_cache()

    # the bf16 forward and dK/dV calls above ran on the tensor cores (one
    # launch each per case's check, the rest timing runs)
    counts = read_flash_counts()
    log("kernel_flash_launches", **counts)
    if min(counts["flash_tc_fwd"], counts["flash_tc_dkv"]) < len(FLASH_CASES):
        raise AssertionError(f"kernel_flash: tensor-core launches {counts}, "
                             f"expected at least {len(FLASH_CASES)} of each")

    # (b)'s dropout bits, exactly, from every kernel in f32 and bf16
    _, B, H, S, D, _, _, p = FLASH_CASES[1]
    _, _, _, _, mask = flash_inputs(rng, B, H, S, D, True, torch.float32)
    want = flash_keep_reference(mask, H, S, FLASH_SEED, p)
    exact = {}
    for dtype in (torch.float32, torch.bfloat16):
        bits = flash_keep_bits(mask, H, S, D, FLASH_SEED, p, dtype)
        exact[str(dtype).split(".")[-1]] = {
            name: bool(torch.equal(got, want)) for name, got in bits.items()}
    log("kernel_flash_bits", case="bert", bits=int(want.numel()),
        kept=int(want.sum()), exact=exact)
    if not all(all(e.values()) for e in exact.values()):
        raise AssertionError(f"flash dropout bits differ from _keep_mask: "
                             f"{exact}")
    return {"max_abs_err": errs, "bits_exact": exact["float32"],
            "bits_exact_bf16": exact["bfloat16"], "launches": counts,
            **timings}


# --------------------------------------------------------------------------
# training phases
# --------------------------------------------------------------------------
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 5
TRAIN_LR, TRAIN_WD = 6e-4, 0.1
# the 2-layer card step vs the same step on the CPU: gradients within
# 1e-4 of each parameter's largest |g| (plus 1e-6 of the model's, for
# parameters whose exact gradient is 0, like the key projection's bias):
# cuBLAS and the CPU's BLAS sum 2048 tokens' products in another order;
# the loss 1e-5 relative
GRAD_TOL, GRAD_FLOOR, LOSS_RTOL = 1e-4, 1e-6, 1e-5


def reset_flash_counts():
    from paddle_tpu_torch.ops.attention import ROUTE_STATS
    from paddle_tpu_torch.ops.flash_attention import (FLASH_ROUTE_STATS,
                                                      FLASH_TC_STATS)

    for stats in (ROUTE_STATS, FLASH_ROUTE_STATS, FLASH_TC_STATS):
        for key in stats:
            stats[key] = 0


def read_flash_counts():
    from paddle_tpu_torch.ops.attention import ROUTE_STATS
    from paddle_tpu_torch.ops.flash_attention import (FLASH_ROUTE_STATS,
                                                      FLASH_TC_STATS)

    return ({f"flash_{k}": v for k, v in FLASH_ROUTE_STATS.items()}
            | {f"flash_tc_{k}": v for k, v in FLASH_TC_STATS.items()}
            | {f"route_{k}": v for k, v in ROUTE_STATS.items()})


def amp_context(amp_dtype):
    """``amp.auto_cast(dtype=amp_dtype)``, or no cast for None."""
    from contextlib import nullcontext

    from paddle_tpu_torch import amp

    return (nullcontext() if amp_dtype is None
            else amp.auto_cast(dtype=amp_dtype))


def train_step(model, opt, x, y, amp_dtype=None):
    """One step of the paddle dygraph loop, the forward under
    ``auto_cast(dtype=amp_dtype)`` when given (the loss reads the logits
    in f32 either way); returns the loss."""
    from paddle_tpu_torch.nn import functional as F

    with amp_context(amp_dtype):
        logits = model(x)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.detach())


# kernel names of the matrix-product libraries (cuBLAS, cuBLASLt)
MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def profile_step(model, opt, x, y, amp_dtype=None) -> dict:
    """One more training step under ``torch.profiler``: device time by
    kernel family (the three flash kernels, matrix products, the rest),
    the costliest other kernels, and the device's busy share of the
    step's wall time (one stream: kernel times add up)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = train_step(model, opt, x, y, amp_dtype)
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {"flash_fwd": 0.0, "flash_dkv": 0.0, "flash_dq": 0.0,
           "matmul": 0.0, "other": 0.0}
    other, n_kernels = [], 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        n_kernels += evt.count
        name = evt.key
        key = next((f"flash_{k}" for k in ("dkv", "dq", "fwd")
                    if f"{k}_kernel<" in name or f"{k}_tc_kernel<" in name),
                   None)
        if key is None and any(m in name.lower() for m in MATMUL_NAMES):
            key = "matmul"
        if key is None:
            key = "other"
            other.append((ms, evt.count, name[:90]))
        fam[key] += ms
    busy = sum(fam.values())
    other.sort(reverse=True)
    return {"loss": loss, "wall_ms": wall_ms, "device_ms": busy,
            "device_busy_share": busy / wall_ms if busy else None,
            "device_kernels": n_kernels, "device_ms_by_family": fam,
            "top_other_kernels": [
                {"ms": ms, "launches": c, "name": n} for ms, c, n in
                other[:8]]}


def train_phase(rng, amp_dtype=None, phase="train") -> dict:
    """GPT-2-small widths, all 12 layers, AdamW(6e-4, wd 0.1), one seeded
    B 8 x S 1024 batch repeated: one warm-up step, then TRAIN_STEPS steps
    with every count set to 0 just before and read just after, then one
    more step under the profiler.  f32, or the forward under
    ``auto_cast(dtype=amp_dtype)`` as ``bench.py`` trains (bf16: the
    forward and dK/dV flash bodies on the tensor cores)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import GPTModel

    t0 = time.perf_counter()
    model = GPTModel(**GPT2_SMALL, device=DEVICE, seed=1234)
    opt = AdamW(TRAIN_LR, parameters=list(model.parameters()),
                weight_decay=TRAIN_WD)
    ids = torch.from_numpy(rng.randint(
        0, GPT2_SMALL["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
        np.int64)).to(DEVICE)
    x, y = ids[:, :-1], ids[:, 1:]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [train_step(model, opt, x, y, amp_dtype)]
    warmup_s = time.perf_counter() - t0
    reset_counts()
    reset_flash_counts()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(train_step(model, opt, x, y, amp_dtype))  # syncs
        step_s.append(time.perf_counter() - t0)
    counts = read_flash_counts() | read_counts()
    n = len(model.layers) * TRAIN_STEPS
    n_tc = n if amp_dtype == "bfloat16" else 0
    want = {"flash_fwd": n, "flash_dkv": n, "flash_dq": n, "flash_ref": 0,
            "flash_tc_fwd": n_tc, "flash_tc_dkv": n_tc,
            "route_pallas": n, "route_xla": 0}
    expect_counts(phase, counts, want)
    prof = profile_step(model, opt, x, y, amp_dtype)
    ln_v = math.log(GPT2_SMALL["vocab_size"])
    result = {
        "amp_dtype": amp_dtype,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "losses": losses, "ln_vocab": ln_v, "init_s": init_s,
        "warmup_step_s": warmup_s, "step_s": step_s,
        "step_ms_p50": float(np.percentile(step_s, 50) * 1e3),
        "step_ms_p95": float(np.percentile(step_s, 95) * 1e3),
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / sum(step_s),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        **counts, "profile": prof}
    log(phase, **result)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    if abs(losses[0] - ln_v) > 0.5:
        raise AssertionError(f"{phase}: first loss {losses[0]} is not "
                             f"within 0.5 of ln(vocab) {ln_v}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall on the "
                             f"repeated batch: {losses}")
    return result


def _off_noise(diff, g_ref, global_max, limit):
    """Entries off ``limit`` whose reference gradient is not at the noise
    floor (where Adam's normalized first step is ±1 either way)."""
    noise = (g_ref.abs() < 1e-4 * g_ref.abs().max()) | (
        g_ref.abs() < GRAD_FLOOR * global_max)
    off = diff > limit
    return off, off & ~noise


def _parity_runs(rng, cfg, batch, seq, amp_dtype):
    """One training step of the same 2-layer GPT (``cfg``) on the card
    and on the CPU's plain flash route (PADDLE_TPU_FORCE_FLASH=1), the
    forward under ``auto_cast(dtype=amp_dtype)`` when given: per device
    the loss, every gradient, the weights after one AdamW step, the
    launch counts and the seconds it took."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import GPTModel

    card = GPTModel(**cfg, device=DEVICE, seed=1234)
    cpu = GPTModel(**cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = rng.randint(0, cfg["vocab_size"], (batch, seq + 1)).astype(
        np.int64)
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        dev = model.device
        x = torch.from_numpy(ids[:, :-1]).to(dev)
        y = torch.from_numpy(ids[:, 1:]).to(dev)
        forced = os.environ.get("PADDLE_TPU_FORCE_FLASH")
        if name == "cpu":
            os.environ["PADDLE_TPU_FORCE_FLASH"] = "1"
        reset_flash_counts()
        t0 = time.perf_counter()
        try:
            with amp_context(amp_dtype):
                logits = model(x)
            loss = F.cross_entropy(logits.reshape(-1, cfg["vocab_size"]),
                                   y.reshape(-1))
            loss.backward()
        finally:
            if forced is None:
                os.environ.pop("PADDLE_TPU_FORCE_FLASH", None)
            else:
                os.environ["PADDLE_TPU_FORCE_FLASH"] = forced
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters()}
        weights0 = {n: p.detach().float().cpu().clone() for n, p in
                    model.named_parameters()}
        opt = AdamW(TRAIN_LR, parameters=list(model.parameters()),
                    weight_decay=TRAIN_WD)
        opt.step()
        opt.clear_grad()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        runs[name] = {"loss": float(loss.detach()), "grads": grads,
                      "weights0": weights0,
                      "weights": {n: p.detach().float().cpu() for n, p in
                                  model.named_parameters()},
                      "counts": read_flash_counts(),
                      "s": time.perf_counter() - t0}
    L = cfg["num_layers"]
    n_tc = L if amp_dtype == "bfloat16" else 0
    expect_counts("train_parity card", runs["card"]["counts"], {
        "flash_fwd": L, "flash_dkv": L, "flash_dq": L, "flash_ref": 0,
        "flash_tc_fwd": n_tc, "flash_tc_dkv": n_tc})
    expect_counts("train_parity cpu", runs["cpu"]["counts"], {
        "flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0, "flash_ref": 3 * L})
    return runs


def train_parity_phase(rng, cfg=None, batch=2, seq=None) -> dict:
    """2 layers at GPT-2-small widths (or ``cfg``), B 2 x S 1024, f32: one
    step's loss and every gradient through the kernels on the card
    against the same step on the CPU through the port's plain flash route
    (PADDLE_TPU_FORCE_FLASH=1), then the weights after one AdamW step."""
    cfg = cfg or dict(GPT2_SMALL, num_layers=2)
    seq = seq or TRAIN_SEQ
    runs = _parity_runs(rng, cfg, batch, seq, None)
    a, b = runs["card"], runs["cpu"]
    loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    gmax = max(float(g.abs().max()) for g in b["grads"].values())
    grad_worst, w_worst, w_noise, n_w, bad = 0.0, 0.0, 0, 0, []
    for name, gb in b["grads"].items():
        err = float((a["grads"][name] - gb).abs().max())
        limit = GRAD_TOL * float(gb.abs().max()) + GRAD_FLOOR * gmax
        grad_worst = max(grad_worst, err / limit)
        if err > limit:
            bad.append(f"grad {name}: {err} > {limit}")
        diff = (a["weights"][name] - b["weights"][name]).abs()
        off, off_signal = _off_noise(diff, gb, gmax, 2e-3 * TRAIN_LR)
        w_noise += int(off.sum())
        n_w += diff.numel()
        w_worst = max(w_worst, float(diff[~off].max()) if (~off).any()
                      else 0.0)
        if off_signal.any() or bool((diff > 2 * TRAIN_LR).any()):
            bad.append(f"weight {name}: {int(off_signal.sum())} entries "
                       f"off {2e-3 * TRAIN_LR} with a gradient above the "
                       f"noise floor")
    result = {"layers": cfg["num_layers"], "batch": batch, "seq": seq,
              "loss_card": a["loss"], "loss_cpu": b["loss"],
              "loss_rel_err": loss_err,
              "grad_worst_err_over_limit": grad_worst,
              "weights_max_abs_err_off_noise": w_worst,
              "weights_noise_entries": w_noise, "weights": n_w,
              "card_s": a["s"], "cpu_s": b["s"],
              "card_counts": a["counts"], "cpu_counts": b["counts"]}
    log("train_parity", **result)
    if loss_err > LOSS_RTOL or bad or w_noise > 0.01 * n_w:
        raise AssertionError(f"train_parity: loss rel err {loss_err} (tol "
                             f"{LOSS_RTOL}), noise entries {w_noise} of "
                             f"{n_w}; {bad[:5]}")
    return result


# the 2-layer bf16-autocast card step vs the same step on the CPU: both
# round to bf16 after every linear, attention and GELU, but cuBLAS and the
# CPU's BLAS take the sums inside them in another order, and the card's
# flash bodies round P and dS to bf16 where the plain version keeps f32,
# so elements differ by a bf16 ulp (2^-8) here and there: the loss within
# 5e-3 relative and each parameter's gradient within 5e-2 of its norm
# (relative L2; two CPU routes differ by 1.3e-2).  The key projections'
# biases have an exact gradient of 0 (a softmax row ignores a constant
# added to all its scores), so theirs is rounding noise on both devices
# and is only held to be small.  Adam's first step moves a weight by lr
# times the sign of its gradient, so where a gradient near 0 changes sign
# the weights differ by 2 lr (1-6 % of a tensor's entries between two CPU
# routes); the card's AdamW step is held instead to the same step on the
# CPU from the card's own gradients, within 1e-3 lr (f32 elementwise ops)
GRAD_REL_BF16, LOSS_RTOL_BF16, NOISE_GRADS = 5e-2, 5e-3, ".attn.k_proj.bias"


def train_parity_bf16_phase(rng, cfg=None, batch=2, seq=None) -> dict:
    """The bf16-autocast twin of :func:`train_parity_phase`: 2 layers at
    GPT-2-small widths (or ``cfg``), B 2 x S 1024, the forward under
    ``auto_cast(dtype="bfloat16")`` on both devices (the card's flash
    forward and dK/dV on the tensor cores), held to the tolerances
    above."""
    from paddle_tpu_torch.optimizer import AdamW

    cfg = cfg or dict(GPT2_SMALL, num_layers=2)
    seq = seq or TRAIN_SEQ
    runs = _parity_runs(rng, cfg, batch, seq, "bfloat16")
    a, b = runs["card"], runs["cpu"]
    loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    gmax = max(float(g.norm()) for g in b["grads"].values())
    # the CPU's AdamW step from the card's start and gradients
    replay = {n: torch.nn.Parameter(w.clone()) for n, w in
              a["weights0"].items()}
    for n, p in replay.items():
        p.grad = a["grads"][n].clone()
    AdamW(TRAIN_LR, parameters=list(replay.values()),
          weight_decay=TRAIN_WD).step()
    grad_rel, step_err, bad = {}, 0.0, []
    for name, gb in b["grads"].items():
        ga = a["grads"][name]
        if name.endswith(NOISE_GRADS):
            if float(ga.norm()) > 1e-2 * gmax:
                bad.append(f"grad {name}: norm {float(ga.norm())} is not "
                           f"rounding noise")
        else:
            grad_rel[name] = float((ga - gb).norm() / gb.norm())
            if grad_rel[name] > GRAD_REL_BF16:
                bad.append(f"grad {name}: relative L2 {grad_rel[name]}")
        step_err = max(step_err, float(
            (a["weights"][name] - replay[name].detach()).abs().max()))
    result = {"layers": cfg["num_layers"], "batch": batch, "seq": seq,
              "loss_card": a["loss"], "loss_cpu": b["loss"],
              "loss_rel_err": loss_err,
              "grad_rel_l2_worst": max(grad_rel.values()),
              "grad_rel_l2": grad_rel, "adamw_step_max_abs_err": step_err,
              "card_s": a["s"], "cpu_s": b["s"],
              "card_counts": a["counts"], "cpu_counts": b["counts"]}
    log("train_parity_bf16", **result)
    if loss_err > LOSS_RTOL_BF16 or bad or step_err > 1e-3 * TRAIN_LR:
        raise AssertionError(
            f"train_parity_bf16: loss rel err {loss_err} (tol "
            f"{LOSS_RTOL_BF16}), AdamW step off by {step_err} (tol "
            f"{1e-3 * TRAIN_LR}); {bad[:5]}")
    return result


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


# the stats kernel's counts, 0 on every single-device drive
NO_STATS = {"attention_cuda_stats": 0, "attention_cuda_stats_int8": 0,
            "attention_ref_stats": 0}


def expect_counts(phase, counts, want):
    got = {k: counts[k] for k in want}
    if got != want or not any(v > 0 for v in want.values()):
        raise AssertionError(f"{phase}: launch counts {counts}, expected "
                             f"{want}: the path did not run on the kernels "
                             f"at every layer of every dispatch")


_REFERENCES = {}


def reference_streams(model, prompts, quant=None):
    """The port's dense ``generate`` (int8 per ``quant``) for every
    prompt, computed once per (model, export, prompts) on the card."""
    from paddle_tpu_torch.text.generation import generate

    key = (id(model), id(quant), tuple(p.tobytes() for p in prompts))
    if key not in _REFERENCES:
        _REFERENCES[key] = [
            generate(model, p[None], max_new_tokens=NEW_TOKENS, end_id=-1,
                     quant=quant)[0][0].cpu().numpy() for p in prompts]
    return _REFERENCES[key]


def check_streams(phase, model, prompts, streams, quant=None, want=None,
                  int8=None):
    """Every stream against the port's dense generate (int8 per
    ``quant``) on the card, or against ``want``; a divergence is allowed
    only at a near tie of the dense reference's top-2 logits, teacher-
    forced through the prompt and the common prefix (the int8 limit when
    ``int8``, default: when ``quant`` is given)."""
    if want is None:
        want = reference_streams(model, prompts, quant)
    if int8 is None:
        int8 = quant is not None
    gap_limit = INT8_NEAR_TIE_GAP if int8 else NEAR_TIE_GAP
    near_ties = []
    for i, (p, got, ref) in enumerate(zip(prompts, streams, want)):
        if not np.isfinite(got).all() or got.shape != ref.shape:
            raise AssertionError(f"{phase} request {i}: bad output {got}")
        diff = np.nonzero(got != ref)[0]
        if diff.size:
            k = int(diff[0])
            gap = logit_gap(model, p, ref, k, quant)
            case = {"request": i, "prompt_len": int(p.size), "position": k,
                    "engine": int(got[k]), "reference": int(ref[k]),
                    "top2_gap": gap, "gap_limit": gap_limit}
            log(f"{phase}_near_tie", **case)
            if gap >= gap_limit:
                raise AssertionError(
                    f"{phase} request {i} diverges from its reference at "
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
                                  "attention_cuda_decode": 0,
                                  "attention_cuda_decode_int8": 0,
                                  "attention_ref": 0, "qmm_cuda": 0,
                                  "qmm_ref": 0, **NO_STATS})
    t0 = time.perf_counter()
    near = check_streams("e2e", model, prompts, streams)
    result = summary(eng, prompts, wall, dispatches, counts, near)
    result["reference_s"] = time.perf_counter() - t0
    log("e2e", **result)
    return result


def e2e_int8_static_phase(model, prompts, rng, native, device="cuda"):
    """int8 KV with scales calibrated on the card, int8 weights: every
    attention call on body #1q, every projection/MLP matmul on body #4.
    Returns (result, the export)."""
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
        "attention_cuda_decode": 0, "attention_cuda_decode_int8": 0,
        "attention_ref": 0, "qmm_cuda": 6 * L * dispatches, "qmm_ref": 0,
        **NO_STATS})
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
    return result, export


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
            "attention_cuda_decode": 0, "attention_cuda_decode_int8": 0,
            "attention_ref": 0, "qmm_cuda": 6 * L * dispatches,
            "qmm_ref": 0, **NO_STATS})
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


def split_forwards(eng) -> int:
    """Core forwards the engine ran through the split programs (each one
    attention launch per layer): decode and prefill dispatches, K per
    fused dispatch, 1 per one-forward verify and K per sequential one."""
    calls = eng.stats()["programs"]
    verify = eng.spec.k if eng.spec is not None and eng.spec.sequential \
        else 1
    return (calls["decode"] + calls["prefill"]
            + eng.fused_steps * calls["decode_fused"]
            + verify * calls["spec_verify"])


# the split drives: (name, engine knobs, int8 KV and weights)
SPLIT_DRIVES = (("split", dict(ragged=False), False),
                ("split_sync", dict(ragged=False, sync_mode=True), False),
                ("fused4", dict(fused_steps=4), False),
                ("split_int8", dict(ragged=False, kv_cache_dtype="int8",
                                    weight_dtype="int8"), True))


def e2e_split_phase(model, prompts, export, ragged_step_ms,
                    device="cuda") -> dict:
    """The split programs on the e2e requests: every attention call on
    the per-row kernel (#2, or #2q with int8 KV), every int8 projection
    on body #4; streams equal to ``generate`` (``generate(quant=
    export)``) except at a reported near-tie; step time beside the
    ragged engine's (``ragged_step_ms``, phase 5's p50)."""
    from paddle_tpu_torch.serving import create_serving_engine

    L = len(model.layers)
    result = {}
    for name, knobs, int8 in SPLIT_DRIVES:
        qs = dict(quant_scales=export) if int8 else {}
        eng = create_serving_engine(model, device=device, **ENGINE, **knobs,
                                    **qs)
        streams, counts, wall, _ = drive(eng, prompts)
        fwd = split_forwards(eng)
        calls = eng.stats()["programs"]
        expect_counts(f"e2e_split/{name}", counts, {
            "attention_cuda": 0, "attention_cuda_int8": 0,
            "attention_cuda_decode": 0 if int8 else L * fwd,
            "attention_cuda_decode_int8": L * fwd if int8 else 0,
            "attention_ref": 0, "qmm_cuda": 6 * L * fwd if int8 else 0,
            "qmm_ref": 0, **NO_STATS})
        if calls["ragged_step"] or (name == "fused4"
                                    and not calls["decode_fused"]):
            raise AssertionError(f"e2e_split/{name}: programs {calls}")
        near = check_streams(f"e2e_split/{name}", model, prompts, streams,
                             export if int8 else None)
        res = summary(eng, prompts, wall, 0, counts, near)
        res.update(programs=calls, split_forwards=fwd,
                   step_ms_p50_vs_ragged=(res["step_ms"]["p50"]
                                          / ragged_step_ms))
        log("e2e_split", drive=name, **res)
        result[name] = res
        del eng
        torch.cuda.empty_cache()
    return result


def spec_prompts(rng, n=8):
    """Prompts made of a short random pattern repeated — the n-gram
    drafter proposes from the prompt's own repeats."""
    out = []
    for i in range(n):
        pat = rng.randint(1, GPT2_SMALL["vocab_size"], (3 + i,))
        out.append(np.tile(pat, 4 + 3 * i).astype(np.int32))
    return out


# the speculative drives: (name, engine knobs); each against the same
# engine with speculation off
SPEC_DRIVES = (("ragged", {}),
               ("split", dict(ragged=False)),
               ("ragged_int8_dynamic", dict(kv_cache_dtype="int8")))


def e2e_spec_phase(model, prompts, device="cuda") -> dict:
    """``spec_decode=4`` on the ragged engine (verify folded into body
    #1), on the split engine (verify on #2) and on the ragged engine with
    uncalibrated int8 KV (the sequential verify and its rollback on #2q,
    the rest on #1q); each drive's streams against the same engine with
    speculation off, a divergence allowed only at a reported near-tie."""
    from paddle_tpu_torch.serving import create_serving_engine

    L = len(model.layers)
    result = {}
    for name, knobs in SPEC_DRIVES:
        int8 = "kv_cache_dtype" in knobs
        off = create_serving_engine(model, device=device, **ENGINE, **knobs)
        want, _, wall_off, _ = drive(off, prompts)
        off_step = off.stats()["metrics"]["step_latency_ms"]["p50"]
        del off
        eng = create_serving_engine(model, device=device, spec_decode=4,
                                    **ENGINE, **knobs)
        streams, counts, wall, _ = drive(eng, prompts)
        calls = eng.stats()["programs"]
        ragged = L * calls["ragged_step"]
        split = L * split_forwards(eng)
        expect_counts(f"e2e_spec/{name}", counts, {
            "attention_cuda": 0 if int8 else ragged,
            "attention_cuda_int8": ragged if int8 else 0,
            "attention_cuda_decode": 0 if int8 else split,
            "attention_cuda_decode_int8": split if int8 else 0,
            "attention_ref": 0, "qmm_cuda": 0, "qmm_ref": 0, **NO_STATS})
        spec = eng.stats()["spec"]
        bad = [] if spec["drafted"] > 0 else ["no drafts"]
        if name == "ragged" and calls["spec_verify"]:
            bad.append("the ragged engine ran the split verifier")
        if name != "ragged" and not calls["spec_verify"]:
            bad.append("no split verify dispatch")
        if int8 and not spec["rollbacks"]:
            bad.append("no rollback")
        if bad:
            raise AssertionError(f"e2e_spec/{name}: {bad}; spec {spec}, "
                                 f"programs {calls}")
        near = check_streams(f"e2e_spec/{name}", model, prompts, streams,
                             want=want, int8=int8)
        res = summary(eng, prompts, wall, calls["ragged_step"], counts,
                      near)
        res.update(programs=calls, spec={k: spec[k] for k in (
            "steps", "drafted", "accepted", "rejected", "rollbacks",
            "degraded", "accept_rate")}, spec_off_wall_s=wall_off,
            spec_off_step_ms_p50=off_step)
        log("e2e_spec", drive=name, **res)
        result[name] = res
        del eng
        torch.cuda.empty_cache()
    return result


# the mesh drives: 4 long prompts at tp 2 x sp 2 in a pool of MESH_PAGES
# pages (130 per sequence shard, fewer than the ~208 the drive holds, so
# sequences span both page shards); int8 KV and weights on the same; then
# speculative decoding at tp 2 on repeated-pattern prompts
MESH_PROMPT_LENS = (600, 730, 860, 990)
MESH_PAGES = 260
MESH_SLOTS = 4
MESH_DRIVES = (("native", {"tp": 2, "sp": 2}, {}),
               ("int8_static", {"tp": 2, "sp": 2},
                dict(kv_cache_dtype="int8", weight_dtype="int8")),
               ("spec_tp2", {"tp": 2}, dict(spec_decode=4)))


def mesh_drive(eng, prompts):
    """Serve ``prompts`` with every count set to 0 just before; on a mesh
    engine, after the first step (every request admitted) record how many
    sequence shards each sequence's pages span.  Returns (streams,
    counts, wall s, spans)."""
    ids = [eng.add_request(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    spans = []
    mesh = eng.stats()["pipeline"]["mesh"]
    if mesh is not None:
        per = eng.cache.num_pages // mesh["sp"]
        spans = sorted(len({p // per for p in
                            eng.cache.seq_page_ids(s.seq_id)})
                       for s in eng.scheduler.running)
    outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if eng.cache.pages_in_use != 0:
        raise AssertionError(f"{eng.cache.pages_in_use} KV pages leaked")
    return [outs[r] for r in ids], counts, wall, spans


def e2e_mesh_phase(model, rng, export, device="cuda") -> dict:
    """The mesh-sharded replica at GPT-2-small width on MESH_SLOTS slots of
    the card: per drive, the single-device engine with the same knobs
    serves the same prompts first (the reference), then the mesh engine;
    streams equal except at a recorded near-tie (at most one), every
    attention launch on the stats kernel at sp 2 (on the ragged kernel at
    sp 1) once per layer, shard and dispatch, one shard step per
    dispatch, no page leaked, sequences on both page shards at sp 2."""
    from paddle_tpu_torch.distributed import force_device_count, get_mesh
    from paddle_tpu_torch.serving import create_serving_engine

    L = len(model.layers)
    long_prompts = [rng.randint(1, GPT2_SMALL["vocab_size"], (n,)).astype(
        np.int32) for n in MESH_PROMPT_LENS]
    result = {}
    prev = force_device_count(MESH_SLOTS)
    try:
        for name, axes, knobs in MESH_DRIVES:
            prompts = spec_prompts(rng, 4) if "spec_decode" in knobs \
                else long_prompts
            int8 = "kv_cache_dtype" in knobs
            qs = dict(quant_scales=export) if int8 else {}
            kw = dict(ENGINE, num_pages=MESH_PAGES, device=device, **knobs,
                      **qs)
            single = create_serving_engine(model, **kw)
            want, _, single_wall, _ = mesh_drive(single, prompts)
            single_step = single.stats()["metrics"]["step_latency_ms"]
            del single
            torch.cuda.empty_cache()
            eng = create_serving_engine(model, mesh_axes=axes, **kw)
            slots = [str(d) for d in get_mesh().slots]
            log("e2e_mesh_slots", drive=name, mesh=dict(axes),
                slot_to_card=slots)
            streams, counts, wall, spans = mesh_drive(eng, prompts)
            st = eng.stats()
            dispatches = st["programs"]["ragged_step"]
            sp = st["pipeline"]["mesh"]["sp"]
            shards = st["pipeline"]["mesh"]["devices"]
            on = L * shards * dispatches
            stats_key = "attention_cuda_stats_int8" if int8 \
                else "attention_cuda_stats"
            ragged_key = "attention_cuda_int8" if int8 else "attention_cuda"
            want_counts = {"attention_cuda": 0, "attention_cuda_int8": 0,
                           "attention_cuda_decode": 0,
                           "attention_cuda_decode_int8": 0,
                           "attention_ref": 0, "qmm_ref": 0, **NO_STATS,
                           "qmm_cuda": 6 * L * shards * dispatches
                           if int8 else 0}
            want_counts[stats_key if sp > 1 else ragged_key] = on
            expect_counts(f"e2e_mesh/{name}", counts, want_counts)
            shard_steps = st["metrics"]["shard"]["steps"]
            bad = []
            if shard_steps != dispatches:
                bad.append(f"serving.shard.steps {shard_steps} != "
                           f"{dispatches} dispatches")
            if sp > 1 and sp not in spans:
                bad.append(f"no sequence spans all {sp} page shards "
                           f"(spans {spans})")
            if "spec_decode" in knobs and not st["spec"]["drafted"]:
                bad.append("no drafts")
            if bad:
                raise AssertionError(f"e2e_mesh/{name}: {bad}")
            near = check_streams(f"e2e_mesh/{name}", model, prompts,
                                 streams, quant=export if int8 else None,
                                 want=want)
            if len(near) > 1:
                raise AssertionError(f"e2e_mesh/{name}: {len(near)} "
                                     f"near-ties, at most one allowed")
            res = summary(eng, prompts, wall, dispatches, counts, near)
            res.update(mesh=st["pipeline"]["mesh"], slot_to_card=slots,
                       page_spans_after_admission=spans,
                       shard=st["metrics"]["shard"],
                       single_device_wall_s=single_wall,
                       single_device_step_ms=single_step,
                       step_ms_label=f"{shards} slots on one card",
                       spec=({k: st["spec"][k] for k in (
                           "drafted", "accepted", "accept_rate")}
                             if "spec_decode" in knobs else None))
            log("e2e_mesh", drive=name, **res)
            result[name] = res
            del eng
            torch.cuda.empty_cache()
    finally:
        force_device_count(prev)
    return result


# row t: the custom-op API's worked kernel, x * scale[0] + shift[0]
SCALE_SHIFT_SHAPES = ((16, 8), (4, 8), (1_000_003,), (8192, 8192))
SCALE_SHIFT_TIMED = ((16, 8), (8192, 8192))
CUSTOM_OP_STEPS = 15
# the custom-op net and LeNet on the card vs the same steps on the CPU
# from the same weights: f32 products of width <= 400 summed in another
# order by cuBLAS/cuDNN (TF32 off), which Adam's normalized step carries
# into the next losses at the level of a few ulps of lr
TRAIN_CPU_RTOL = 1e-4
LENET_BATCH = 64
LENET_STEPS = 30
LENET_PARITY_STEPS = 5


def scale_shift_bound_ms(numel, item):
    """Least time on an H100: x read once and the output written once
    over HBM bandwidth (two flops an element are far below the f32
    peak)."""
    return 2 * numel * item / HBM_BYTES_PER_S * 1e3, "bytes"


def scale_shift_kernel_phase(rng, flush) -> dict:
    """Row t's kernel against its plain version at the custom-op net's
    shape [16, 8], the math test's [4, 8], an odd 1-D size and [8192,
    8192], f32 and bf16: bit for bit; an empty x launches nothing.
    Timed at [16, 8] and [8192, 8192] beside the bound, the plain
    version and ``torch.addcmul(shift, x, scale)``."""
    from paddle_tpu_torch.ops import scale_shift as ss

    scale = torch.tensor([1.37], device=DEVICE)
    shift = torch.tensor([-0.21], device=DEVICE)
    timings = {}
    for shape in SCALE_SHIFT_SHAPES:
        xf = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            x = xf.to(dtype)
            out = ss.scale_shift_cuda(x, scale, shift)
            torch.cuda.synchronize()
            ref = ss.scale_shift_ref(x, scale, shift)
            err = float((out.float() - ref.float()).abs().max())
            exact = bool(torch.equal(out, ref))
            tag = f"{'x'.join(map(str, shape))}/{str(dtype).split('.')[-1]}"
            log("kernel_scale_shift", case=tag, max_abs_err=err,
                bit_equal=exact)
            if not exact:
                raise AssertionError(f"scale_shift kernel differs from its "
                                     f"plain version on {tag}: max_abs_err "
                                     f"{err}")
            if shape in SCALE_SHIFT_TIMED:
                t = {"max_abs_err": err,
                     "ms": time_ms(lambda: ss.scale_shift_cuda(
                         x, scale, shift), flush),
                     "plain_ms": time_ms(
                         lambda: ss.scale_shift_ref(x, scale, shift), flush),
                     "library_ms": time_ms(
                         lambda: torch.addcmul(shift, x, scale), flush)}
                t["bound_ms"], t["bound_by"] = scale_shift_bound_ms(
                    x.numel(), x.element_size())
                log("kernel_scale_shift_time", case=tag, **t)
                timings[tag] = t
            del x, out, ref
        del xf
        torch.cuda.empty_cache()
    before = ss.SCALE_SHIFT_ROUTE_STATS["cuda"]
    empty = ss.scale_shift_cuda(torch.empty((0, 8), device=DEVICE), scale,
                                shift)
    if ss.SCALE_SHIFT_ROUTE_STATS["cuda"] != before or empty.shape != (0, 8):
        raise AssertionError("scale_shift launched on an empty x")
    return timings


def _scale_shift_layer_cls():
    from paddle_tpu_torch import nn

    class ScaleShiftLayer(nn.Layer):
        """The port's twin of tests/test_custom_op.py's
        ``_PallasScaleLayer``: 1-element scale and shift, passed 0-d."""

        def __init__(self, op):
            super().__init__()
            self._op = op
            self.scale = self.create_parameter([1])
            self.shift = self.create_parameter([1], is_bias=True)

        def forward(self, x):
            return self._op(x, self.scale.reshape([]),
                            self.shift.reshape([]))

    return ScaleShiftLayer


def _on_device(device, build):
    """``build()`` with ``device`` as the default place, put back after."""
    from paddle_tpu_torch.framework import place

    prev = place._DEFAULT["device"]
    place.set_device(device)
    try:
        return build()
    finally:
        place._DEFAULT["device"] = prev


def custom_op_phase(device="cuda") -> dict:
    """tests/test_custom_op.py's eager drive through the port's
    ``register_op``: ``Sequential(Linear(8, 8), ScaleShiftLayer(op),
    Linear(8, 1))`` with the op registered as ``scale_shift`` with its
    vjp, 15 ``Adam(5e-2)`` steps on the card from the initial weights of
    the same net built on the CPU under ``seed(0)``, against the same
    steps on the CPU.  Every count set to 0 just before the card's drive:
    one forward and one dx launch a step, no plain call; the loss halves;
    the losses equal the CPU's within TRAIN_CPU_RTOL."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.nn.layer import state_from_numpy
    from paddle_tpu_torch.ops import scale_shift as ss
    from paddle_tpu_torch.utils import register_op

    op = register_op("scale_shift", ss.scale_shift, vjp=ss.scale_shift_vjp,
                     exist_ok=True)
    layer_cls = _scale_shift_layer_cls()
    rng = np.random.RandomState(0)
    xa = rng.randn(16, 8).astype(np.float32)
    ya = (rng.randn(16, 1) * 0.1 + 1.0).astype(np.float32)

    def build():
        return nn.Sequential(nn.Linear(8, 8), layer_cls(op), nn.Linear(8, 1))

    def train(net):
        opt = optimizer.Adam(5e-2, parameters=net.parameters())
        x, y = pt.to_tensor(xa), pt.to_tensor(ya)
        losses = []
        for _ in range(CUSTOM_OP_STEPS):
            loss = ((net(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        return losses

    def cpu_run():
        pt.seed(0)
        net = build()
        state = {k: v.numpy() for k, v in net.state_dict().items()}
        return state, train(net)

    def card_run():
        net = build()
        net.set_state_dict(state_from_numpy(state, device))
        for key in ss.SCALE_SHIFT_ROUTE_STATS:
            ss.SCALE_SHIFT_ROUTE_STATS[key] = 0
        losses = train(net)
        return losses, dict(ss.SCALE_SHIFT_ROUTE_STATS)

    state, cpu_losses = _on_device("cpu", cpu_run)
    losses, counts = _on_device(device, card_run)
    route = "cuda" if torch.device(device).type == "cuda" else "ref"
    want = {"cuda": 0, "ref": 0, route: 2 * CUSTOM_OP_STEPS}
    rel = float(np.max(np.abs(np.subtract(losses, cpu_losses))
                       / np.abs(cpu_losses)))
    res = {"losses": losses, "cpu_losses": cpu_losses,
           "max_rel_diff_vs_cpu": rel, "rtol": TRAIN_CPU_RTOL,
           "scale_shift_launches": counts}
    log("custom_op", **res)
    if counts != want:
        raise AssertionError(f"custom_op: launches {counts}, want {want}")
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"custom_op: the loss did not halve: {losses}")
    if not rel <= TRAIN_CPU_RTOL:
        raise AssertionError(f"custom_op: losses differ from the CPU's by "
                             f"{rel} relative (rtol {TRAIN_CPU_RTOL})")
    return res


def lenet_phase(device="cuda") -> dict:
    """Dygraph LeNet (BASELINE.json config 1) through the port's core:
    ``Adam(1e-3)`` on the synthetic MNIST, the first LENET_STEPS batches
    of LENET_BATCH in order, f32 (TF32 off).  The weights come from the
    port's LeNet built on the CPU under ``seed(0)``; the first
    LENET_PARITY_STEPS losses must equal the same steps on the CPU within
    TRAIN_CPU_RTOL and the mean of the last 5 losses must be below that
    of the first 5.  Step times on the host clock, each step ending in a
    sync (the first step, with cuDNN's set-up, reported apart)."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn.layer import state_from_numpy
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    ds = MNIST(mode="train")
    batches = [ds.batch(i * LENET_BATCH, LENET_BATCH)
               for i in range(LENET_STEPS)]

    def run(model, n, sync):
        opt = optimizer.Adam(1e-3, parameters=model.parameters())
        data = [(pt.to_tensor(x), pt.to_tensor(y)) for x, y in batches[:n]]
        losses, step_ms = [], []
        for x, y in data:
            sync()
            t0 = time.perf_counter()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return losses, step_ms

    def cpu_run():
        pt.seed(0)
        model = LeNet()
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        return state, run(model, LENET_PARITY_STEPS, lambda: None)[0]

    def card_run():
        model = LeNet()
        model.set_state_dict(state_from_numpy(state, device))
        sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
                else (lambda: None))
        return run(model, LENET_STEPS, sync)

    state, cpu_losses = _on_device("cpu", cpu_run)
    losses, step_ms = _on_device(device, card_run)
    head = losses[:LENET_PARITY_STEPS]
    rel = float(np.max(np.abs(np.subtract(head, cpu_losses))
                       / np.abs(cpu_losses)))
    steady = step_ms[1:]
    p50 = float(np.percentile(steady, 50))
    res = {"batch": LENET_BATCH, "steps": LENET_STEPS, "losses": losses,
           "cpu_losses": cpu_losses, "max_rel_diff_vs_cpu": rel,
           "rtol": TRAIN_CPU_RTOL, "first_step_ms": step_ms[0],
           "step_ms_p50": p50,
           "step_ms_p95": float(np.percentile(steady, 95)),
           "images_per_s": LENET_BATCH / (p50 / 1e3)}
    log("lenet", **res)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"lenet: non-finite loss {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"lenet: the loss did not fall: {losses}")
    if not rel <= TRAIN_CPU_RTOL:
        raise AssertionError(f"lenet: the first {LENET_PARITY_STEPS} losses "
                             f"differ from the CPU's by {rel} relative "
                             f"(rtol {TRAIN_CPU_RTOL})")
    return res


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
    report["kernel_flash"] = flash_t = flash_kernel_phase(rng, flush)
    report["kernel_decode"] = decode_t = decode_kernel_phase(rng, flush)
    report["kernel_stats"] = stats_t = stats_kernel_phase(rng, flush)
    # row t draws from its own seed, so the phases after it see the same
    # draws as before it existed
    report["kernel_scale_shift"] = ss_t = scale_shift_kernel_phase(
        np.random.RandomState(6), flush)
    del flush
    torch.cuda.empty_cache()
    # the training drive's batch comes from its own seed, so its loss
    # trajectory does not depend on what the phases before it drew
    report["train"] = train = train_phase(np.random.RandomState(0))
    torch.cuda.empty_cache()
    report["train_bf16"] = train_bf16 = train_phase(
        np.random.RandomState(0), "bfloat16", "train_bf16")
    torch.cuda.empty_cache()
    report["train_parity"] = train_parity_phase(rng)
    torch.cuda.empty_cache()
    # its own seed, so the phases after it see the draws of before
    report["train_parity_bf16"] = train_parity_bf16_phase(
        np.random.RandomState(7))
    torch.cuda.empty_cache()
    report["custom_op"] = custom = custom_op_phase()
    report["lenet"] = lenet_phase()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = GPTModel(**GPT2_SMALL, device="cuda", seed=1234)
    torch.cuda.synchronize()
    log("model", init_s=time.perf_counter() - t0)
    prompts = [rng.randint(1, GPT2_SMALL["vocab_size"], (n,)).astype(
        np.int32) for n in PROMPT_LENS]
    report["e2e"] = e2e = e2e_phase(model, prompts)
    torch.cuda.empty_cache()
    report["e2e_int8_static"], export = e2e_int8_static_phase(
        model, prompts, rng, e2e)
    st = report["e2e_int8_static"]
    torch.cuda.empty_cache()
    report["e2e_int8_dynamic"] = e2e_int8_dynamic_phase(model, prompts[:4])
    torch.cuda.empty_cache()
    report["e2e_split"] = split = e2e_split_phase(
        model, prompts, export, e2e["step_ms"]["p50"])
    report["e2e_spec"] = e2e_spec_phase(model, spec_prompts(rng))
    torch.cuda.empty_cache()
    report["e2e_mesh"] = mesh = e2e_mesh_phase(model, rng, export)

    dec = native_t["gpt2_decode/float32/Qb1"]
    idec = int8_t["gpt2_decode/float32/Qb1/fused_dequant=1"]
    qdec = qmm_t["fc1_768x3072/M8/float32"]
    flash_src = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
    flash_tpu = "paddle_tpu/ops/pallas_ops/flash_attention.py"
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
    ] + [
        record(f"flash_attention_{kname}", flash_src, f"{flash_tpu}:{line}",
               train[f"flash_{kname}"], flash_t[f"{kname}/train/float32"],
               case="B8 H12 S1024 D64 causal, float32",
               bfloat16=dict(flash_t[f"{kname}/train/bfloat16"],
                             launches_train_bf16=train_bf16[
                                 f"flash_{kname}"]),
               max_abs_err_by_case={c: e[kname] for c, e in
                                    flash_t["max_abs_err"].items()},
               dropout_bits_exact=flash_t["bits_exact"][kname])
        for kname, line in (("fwd", 289), ("dkv", 332), ("dq", 377))] + [
        record(f"flash_attention_{kname}_bf16_tc", flash_src,
               f"{flash_tpu}:{line}", train_bf16[f"flash_tc_{kname}"],
               flash_t[f"{kname}/train/bfloat16"],
               case="B8 H12 S1024 D64 causal, bfloat16",
               design=FLASH_TC_DESIGN,
               max_abs_err_by_case={c: e[kname] for c, e in
                                    flash_t["max_abs_err"].items()
                                    if c.endswith("bfloat16")},
               dropout_bits_exact=flash_t["bits_exact_bf16"][kname])
        for kname, line in (("fwd", 289), ("dkv", 332))] + [
        record("paged_attention",
               "paddle_tpu_torch/ops/csrc/paged_decode.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:122",
               split["split"]["attention_cuda_decode"],
               decode_t["gpt2_decode/float32"],
               case="gpt2_decode/float32",
               prefill_chunk=decode_t["gpt2_chunk/float32"],
               bf16_max_abs_err=decode_t["bf16_max_abs_err"],
               launches_by_drive={k: v["attention_cuda_decode"]
                                  for k, v in split.items()}),
        record("paged_attention_int8",
               "paddle_tpu_torch/ops/csrc/paged_decode.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:173",
               split["split_int8"]["attention_cuda_decode_int8"],
               decode_t["gpt2_decode/float32/int8/fused_dequant=1"],
               case="gpt2_decode/float32/int8", fused_dequant=1,
               settings={k: v for k, v in decode_t.items()
                         if "/int8/" in k},
               nan_scale_ok=decode_t["nan_scale_ok"],
               bf16_max_abs_err=decode_t["int8_bf16_max_abs_err"],
               launches_spec_int8_dynamic=report["e2e_spec"][
                   "ragged_int8_dynamic"]["attention_cuda_decode_int8"]),
        record("ragged_paged_attention_stats",
               "paddle_tpu_torch/ops/csrc/paged_attention_stats.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:681",
               mesh["native"]["attention_cuda_stats"],
               stats_t["decode_h12/float32"], case="decode_h12/float32",
               prefill=stats_t["prefill_h12/float32"],
               bf16_max_abs_err=stats_t["bf16_max_abs_err"],
               max_abs_err_by_case={
                   k: v for k, v in stats_t["max_abs_err_by_case"].items()
                   if "int8" not in k},
               library_is="aten._scaled_dot_product_efficient_attention "
                          "with its log-sum-exp, on the gathered owned KV"),
        record("ragged_paged_attention_stats_int8",
               "paddle_tpu_torch/ops/csrc/paged_attention_stats.cu",
               "paddle_tpu/ops/pallas_ops/paged_attention.py:737",
               mesh["int8_static"]["attention_cuda_stats_int8"],
               stats_t["decode_h12/float32/int8/fused_dequant=1"],
               case="decode_h12/float32/int8", fused_dequant=1,
               settings={k: v for k, v in stats_t.items()
                         if "/int8/" in k},
               nan_scale_ok=stats_t["nan_scale_ok"],
               bf16_max_abs_err=stats_t["int8_bf16_max_abs_err"],
               max_abs_err_by_case={
                   k: v for k, v in stats_t["max_abs_err_by_case"].items()
                   if "int8" in k},
               library_is="aten._scaled_dot_product_efficient_attention "
                          "with its log-sum-exp, on the gathered owned, "
                          "dequantized KV"),
        record("scale_shift", "paddle_tpu_torch/ops/csrc/scale_shift.cu",
               "tests/test_custom_op.py:94",
               custom["scale_shift_launches"]["cuda"],
               ss_t["16x8/float32"], case="16x8/float32",
               large={k: v for k, v in ss_t.items() if "8192" in k},
               bf16=ss_t["16x8/bfloat16"],
               library_is="torch.addcmul(shift, x, scale)")]
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
