"""Time the paged kernels' decode form as built from this tree against the
same C interface built with other split sizes or from other source trees
(an older checkout), on long lanes and on the short lanes a server sees.

Run on a machine with one NVIDIA card and the CUDA toolkit:

    python tools/paged_decode_probe.py [--tiles F32,OTHER ...]
        [--tree NAME=CSRC_DIR ...] [--out FILE.json]

Builds ``paged_decode.cu`` (the per-row kernel, which is the decode form
at one row a lane) of ``paddle_tpu_torch/ops/csrc`` as it is, once more
per ``--tiles`` pair with ``PTT_DECODE_TILES_F32`` / ``PTT_DECODE_TILES``
set to it (the 32-position tiles of a full table a warp is sized to
take, f32 pools and the others, so the clusters are smaller or larger),
and once per ``--tree`` from that directory's sources.  All builds start
together.  Every build is checked against the plain version on every
case (f32 pools and int8 pools at ``fused_dequant`` 1) and timed with
``chip_smoke.time_ms`` (L2 flushed, median of 30) in turns: the builds in
order, then in reverse.  ``bit_equal`` says whether a build's output is
the shipped build's, bit for bit.  The cases (H 12, D 64, P 16, 64 pages
a table, unless named): chip_smoke's timed per-row cases, the serving
drive's 8 lanes at their first and last decode step (``PROMPT_LENS`` +
1 and + ``NEW_TOKENS``), 64 lanes of serving lengths, 8 and 64 lanes of
one position, 64 of 16 and 64 full tables.  Prints one JSON object with
the card's name and power limit, each case's bound and each build's
times and errors.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402

CSRC = ROOT / "paddle_tpu_torch/ops/csrc"
GPT2 = dict(H=12, D=64, P=16, M=64)
SERVE = [p + 1 + 4 * k for k in range(8) for p in cs.PROMPT_LENS]
CASES = [(n, dict(cs.DECODE_CASES)[n]) for n in cs.DECODE_TIMED] + [
    ("serve8_first", dict(GPT2, lens=[p + 1 for p in cs.PROMPT_LENS])),
    ("serve8_last", dict(GPT2, lens=[p + cs.NEW_TOKENS
                                     for p in cs.PROMPT_LENS])),
    ("serve64", dict(GPT2, lens=SERVE)),
    ("short8x1", dict(GPT2, lens=[1] * 8)),
    ("short64x1", dict(GPT2, lens=[1] * 64)),
    ("short64x16", dict(GPT2, lens=[16] * 64)),
    ("full64x1024", dict(GPT2, lens=[1024] * 64))]


def build(tmp: Path, name: str, csrc: Path, defines=()) -> ctypes.CDLL:
    out = tmp / f"libdecode_{name}.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *defines,
                    "-o", str(out), str(csrc / "paged_decode.cu")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def bind(lib, quant):
    fn = getattr(lib, pa._KERNEL_FNS["paged_decode", torch.float32, quant])
    n_ptr, n_int = (8, 6) if quant else (6, 5)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", action="append", default=[],
                    help="F32,OTHER tiles a warp, e.g. 8,4")
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=CSRC_DIR of another source tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_decode_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    jobs = {"shipped": (CSRC, ())}
    for t in args.tiles:
        f32, other = t.split(",")
        jobs[f"tiles{f32}_{other}"] = (CSRC, (
            f"-DPTT_DECODE_TILES_F32={f32}", f"-DPTT_DECODE_TILES={other}"))
    for t in args.tree:
        name, path = t.split("=", 1)
        jobs[name] = (Path(path), ())
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    report = {"card": cs.card_line(), "builds": {
        n: {"csrc": str(src), "defines": list(d)}
        for n, (src, d) in jobs.items()}}
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(jobs)) as pool:
            libs = dict(zip(jobs, pool.map(
                lambda kv: build(Path(tmp), kv[0], *kv[1]), jobs.items())))
        rng = np.random.RandomState(0)
        for name, kw in CASES:
            args_f = cs.make_rows(rng, **kw)
            q, kq, vq, ks, vs = (args_f[0],) + cs.quantize_pools(*args_f[1:3])
            for quant in (False, True):
                a = ((q, kq, vq, args_f[3], args_f[4], ks, vs) if quant
                     else args_f)
                kwargs = {"fused_dequant": 1} if quant else {}
                ref = pa.paged_attention_ref(*a)
                key = ("paged_decode", torch.float32, quant)
                pa._kernel(*key)
                bound = pa._BOUND[key]
                fns = {n: bind(lib, quant) for n, lib in libs.items()}

                def run(fn):
                    pa._BOUND[key] = fn
                    return pa.paged_attention_cuda(*a, **kwargs)

                tag = f"{name}/{'int8' if quant else 'float32'}"
                res = {"bound_ms": cs.rows_bound_ms(q, a[1], a[3], a[4])[0]}
                outs = {}
                for n, fn in fns.items():
                    outs[n] = run(fn)
                    torch.cuda.synchronize()
                    res[n] = {"max_abs_err": float(
                        (outs[n].float() - ref).abs().max()),
                        "bit_equal": bool(torch.equal(outs[n],
                                                      outs["shipped"])),
                        "ms": []}
                order = list(fns) + list(fns)[::-1]
                for n in order:
                    res[n]["ms"].append(cs.time_ms(lambda: run(fns[n]),
                                                   flush))
                pa._BOUND[key] = bound
                report[tag] = res
                print(tag, json.dumps({n: r["ms"] for n, r in res.items()
                                       if isinstance(r, dict)}), flush=True)
    text = json.dumps(report)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
