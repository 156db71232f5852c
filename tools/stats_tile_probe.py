"""Time the stats kernel's prefill form at head dim 256 with tiles of 32
compacted positions (the shipped ``kPfTk8``) against tiles of 16.

Run on a machine with one NVIDIA card and the CUDA toolkit:

    python tools/stats_tile_probe.py [--out FILE.json]

Builds ``paddle_tpu_torch/ops/csrc/paged_attention_stats.cu`` as it is
and a copy with ``kPfTk8 = 16`` (whose instances then ask for two
resident blocks an SM), checks the copy against the plain version on
chip_smoke's ``d256_prefill`` case (f32, bf16 and int8 pools), and times
both with ``chip_smoke.time_ms`` (L2 flushed, median of 30) in turns:
shipped, copy, copy, shipped.  Prints one JSON object with the card's
name and power limit, each variant's times and the copy's errors.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402

SHIPPED = "constexpr int kPfTk8 = 32;"
CASE = "d256_prefill"


def build_variant(tmp: Path, tk: int) -> ctypes.CDLL:
    src_dir = tmp / "csrc"
    src_dir.mkdir()
    for f in (ROOT / "paddle_tpu_torch/ops/csrc").iterdir():
        text = f.read_text()
        if f.name == "paged_attention_stats.cuh":
            assert text.count(SHIPPED) == 1
            text = text.replace(SHIPPED, f"constexpr int kPfTk8 = {tk};")
        (src_dir / f.name).write_text(text)
    out = tmp / "libstats_variant.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src_dir / "paged_attention_stats.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(out))


def bind(lib, dtype, quant):
    fn = getattr(lib, pa._KERNEL_FNS["paged_attention_stats", dtype, quant])
    n_ptr, n_int = (10, 7) if quant else (8, 6)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stats_tile_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    rng = np.random.RandomState(0)
    kw = dict(cs.STATS_CASES)[CASE]
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    report = {"card": cs.card_line(), "case": CASE, "shapes": {
        k: v for k, v in kw.items() if k != "row_gaps"}}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_variant(Path(tmp), 16)
        for dtype, quant in ((torch.float32, False),
                             (torch.bfloat16, False), (torch.float32, True)):
            q, kp, vp, pt, rl = cs.make_case(rng, dtype=dtype, **kw)
            ok = cs.stats_page_ok(pt)
            args_ = (q, kp, vp, pt, rl, ok)
            if quant:
                kq, vq, ks, vs = cs.quantize_pools(kp, vp)
                args_ = (q, kq, vq, pt, rl, ok, ks, vs)
            ref_o, ref_lse = pa.ragged_paged_attention_stats_ref(
                *(a.float() if a.is_floating_point() else a for a in args_))
            key = ("paged_attention_stats", dtype, quant)
            pa._kernel(*key)
            shipped, variant = pa._BOUND[key], bind(lib, dtype, quant)

            def run(fn):
                pa._BOUND[key] = fn
                return pa.ragged_paged_attention_stats_cuda(*args_)

            o, lse = run(variant)
            torch.cuda.synchronize()
            tag = f"{str(dtype).split('.')[-1]}{'/int8' if quant else ''}"
            times = {"tk32": [], "tk16": []}
            for name, fn in (("tk32", shipped), ("tk16", variant),
                             ("tk16", variant), ("tk32", shipped)):
                times[name].append(cs.time_ms(lambda: run(fn), flush))
            pa._BOUND[key] = shipped
            report[tag] = {
                "tk16_max_abs_err": float((o.float() - ref_o).abs().max()),
                "tk16_lse_max_abs_err": float((lse - ref_lse).abs().max()),
                "tk32_ms": times["tk32"], "tk16_ms": times["tk16"],
                "bound_ms": cs.stats_bound_ms(q, args_[1], pt, rl, ok)[0]}
    text = json.dumps(report)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
