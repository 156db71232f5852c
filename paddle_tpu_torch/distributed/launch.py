"""python -m paddle_tpu_torch.distributed.launch — multi-process launcher,
twin of ``paddle_tpu/distributed/launch.py``.

Reference analog: fleet/launch.py:334 launch() + launch_utils.py
(Cluster/Pod env contract :57, start_local_trainers :435,
watch_local_trainers :526).  Sets the PADDLE_TRAINER_* env contract per child
and watches them: any abnormal exit terminates the pod (same watchdog
semantics; no restart — §5.3).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated node ips")
    p.add_argument("--started_port", type=int, default=36789)
    p.add_argument("--gloo_port", type=int, default=0,
                   help="rendezvous port for the host (gloo) collective "
                        "backend; 0 = started_port + nproc_per_node")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def start_local_trainers(args):
    ips = args.ips.split(",")
    nnodes = len(ips)
    nproc = args.nproc_per_node
    world = nnodes * nproc
    endpoints = []
    for ip in ips:
        for i in range(nproc):
            endpoints.append(f"{ip}:{args.started_port + i}")
    procs = []
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    gloo_port = args.gloo_port or (args.started_port + nproc)
    gloo_ep = f"{ips[0]}:{gloo_port}"
    for local_rank in range(nproc):
        rank = args.node_rank * nproc + local_rank
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            # host-side eager collectives (LocalSGD averaging, global
            # shuffle, fleet.util) rendezvous here — rank 0 hosts
            "PADDLE_GLOO_ENDPOINT": gloo_ep,
            "FLAGS_selected_gpus": str(local_rank),
        })
        log = (open(os.path.join(args.log_dir, f"workerlog.{local_rank}"), "w")
               if args.log_dir else None)
        cmd = [sys.executable, "-u", args.training_script] + args.training_script_args
        procs.append((subprocess.Popen(cmd, env=env, stdout=log, stderr=log), log))
    return procs


def watch_local_trainers(procs):
    """Poll children; on abnormal exit terminate all (launch_utils.py:526)."""
    alive = True
    while alive:
        alive = False
        for proc, _ in procs:
            ret = proc.poll()
            if ret is None:
                alive = True
            elif ret != 0:
                for p2, _ in procs:
                    if p2.poll() is None:
                        p2.send_signal(signal.SIGTERM)
                raise RuntimeError(f"trainer {proc.pid} exited with code {ret}")
        time.sleep(1)


def launch(argv=None):
    args = _parse_args(argv)
    procs = start_local_trainers(args)
    try:
        watch_local_trainers(procs)
    finally:
        for _, log in procs:
            if log:
                log.close()


if __name__ == "__main__":
    launch()
