"""dist.spawn — twin of ``paddle_tpu/distributed/spawn.py`` (reference:
distributed/spawn.py:317).

Multi-*device* work is one process over the device mesh
(``distributed/mesh.py``), so spawn only starts processes for multi-host
runs: each child gets the PADDLE_TRAINER_* env contract and calls
``func(*args)``.
"""
from __future__ import annotations

import multiprocessing
import os


def _worker(func, rank, nprocs, args, env):
    os.environ.update(env)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    if nprocs == -1:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if nprocs <= 1:
        func(*args)
        return None
    ctx = multiprocessing.get_context("spawn")
    procs = []
    base_port = int(options.get("started_port", 36789))
    endpoints = ",".join(f"127.0.0.1:{base_port + i}" for i in range(nprocs))
    for rank in range(nprocs):
        env = {
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT": f"127.0.0.1:{base_port + rank}",
        }
        p = ctx.Process(target=_worker, args=(func, rank, nprocs, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        for p in procs:
            if p.exitcode != 0:
                raise RuntimeError(f"spawned process exited with {p.exitcode}")
    return procs
