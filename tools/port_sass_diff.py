"""Compare the SASS of the port's CUDA kernels built from two source trees.

Run on a machine with the CUDA toolkit (``nvcc``, ``cuobjdump``):

    python tools/port_sass_diff.py OLD_CSRC NEW_CSRC [--out FILE.json]
        [--only NAME ...] [--rename OLD_REGEX=NEW ...]

Each ``<name>.cu`` of both trees (``paddle_tpu_torch/ops/csrc`` of two
checkouts) is compiled to a cubin with the flags of
``paddle_tpu_torch/ops/_build.py`` (all builds started together), its
SASS listed with ``cuobjdump -sass``, and every kernel's listing compared
with the same kernel's from the other tree, after normalising what
differs between two builds of the same code: the hash in the mangled
name of the anonymous namespace, and the addresses and encodings beside
each instruction.  A kernel renamed between the trees is matched by
``--rename``, a regular-expression substitution on OLD's mangled names
(e.g. ``'29ragged_paged_attention_kernelI(.*?)Lb1EE=17stats_warp_kernelI\1E'``
for the stats kernel's warp form, which lost its always-true ``kStats``
parameter).  Prints one JSON object: per source, the kernels whose SASS
is identical, those that differ (with their instruction counts and the
first differing lines) and those found in one tree only.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from paddle_tpu_torch.ops import _build  # noqa: E402

CUBIN_FLAGS = [f for f in _build.NVCC_FLAGS
               if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas",
                            "-v")]


def sass(src: Path, work: Path) -> dict:
    """{kernel name: normalised SASS lines} of one source."""
    cubin = work / f"{src.stem}.cubin"
    subprocess.run([_build.nvcc_path(), *CUBIN_FLAGS, "-cubin", "-o",
                    str(cubin), str(src)], check=True, capture_output=True)
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N_",
                          m.group(1))
            out[name] = []
        elif name is not None and line.strip():
            code = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
            out[name].append(" ".join(code.split()))
    return out


def compare(old: dict, new: dict) -> dict:
    same = sorted(n for n in old if n in new and old[n] == new[n])
    differ = {}
    for n in sorted(set(old) & set(new)):
        if old[n] != new[n]:
            pairs = [(a, b) for a, b in zip(old[n], new[n]) if a != b]
            differ[n] = {"old_lines": len(old[n]), "new_lines": len(new[n]),
                         "first": pairs[:3]}
    return {"identical": len(same), "differ": differ,
            "old_only": sorted(set(old) - set(new)),
            "new_only": sorted(set(new) - set(old))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--only", nargs="*", default=None,
                    help="source names (default: every .cu of NEW)")
    ap.add_argument("--rename", action="append", default=[],
                    metavar="OLD_REGEX=NEW",
                    help="substitution on OLD's kernel names")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    renames = [r.split("=", 1) for r in args.rename]
    names = args.only or sorted(p.stem for p in args.new.glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        (work / "old").mkdir()
        (work / "new").mkdir()
        jobs = [(tree, name) for name in names for tree in ("old", "new")]
        root = {"old": args.old, "new": args.new}
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            listings = dict(zip(jobs, pool.map(
                lambda j: sass(root[j[0]] / f"{j[1]}.cu", work / j[0]),
                jobs)))
    def renamed(listing):
        for pat, repl in renames:
            listing = {re.sub(pat, repl, n): v for n, v in listing.items()}
        return listing

    report = {name: compare(renamed(listings["old", name]),
                            listings["new", name]) for name in names}
    text = json.dumps(report, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
