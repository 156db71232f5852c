"""Card-vs-CPU table parity of ``chip_smoke.py``'s CTR arm, repeated for
two heads: PaddleRec dnn's ReLU tower (fc 512-256-128-32) and a logistic
head (``fc=()``).  Each repeat runs ``chip_smoke.ctr_parity`` on the same
first CTR_PARITY_BATCHES batches of the arm's synthetic dataset and
prints one JSON line: the largest row difference, the table's largest
element, the relative L2, the rows over the bound and the host syncs of
one steady step on the card.

Run from the repository root on a machine with one NVIDIA card:

    python3 tools/ctr_parity_repeats.py [--out FILE.json]
"""
import argparse
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the repeats to this JSON file")
    ap.add_argument("--repeats", type=int, default=3,
                    help="repeats of each head, interleaved")
    args = ap.parse_args()

    import chip_smoke as cs
    from paddle_tpu_torch.distributed import fleet

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    work = tempfile.mkdtemp(prefix="ctr_parity_")
    try:
        ds = fleet.InMemoryDataset()
        ds.set_slots(cs._ctr_slots())
        ds.set_filelist(cs.write_ctr_files(work))
        ds.set_batch_size(cs.CTR_BATCH)
        ds.set_thread(cs.CTR_THREADS)
        ds.load_into_memory()
        ds.set_shuffle_seed(7)
        ds.local_shuffle()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    first = list(itertools.islice(ds.iter_batches(0, 1),
                                  cs.CTR_PARITY_BATCHES))
    out = []
    for fc in (cs.CTR_FC, ()) * args.repeats:
        t0 = time.perf_counter()
        par, syncs = cs.ctr_parity(first, fc=fc)
        par["syncs"] = syncs
        par["seconds"] = time.perf_counter() - t0
        out.append(par)
        print(json.dumps(par), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
