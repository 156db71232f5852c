"""Child of ``tests/test_torch_gloo.py``'s launch test, started by
``python -m paddle_tpu_torch.distributed.launch``: the launcher's env
contract, the gloo rendezvous, and LocalSGD at k 1 (each trainer's half
of the batch, its parameters averaged over the trainers after every SGD
step) beside full-batch SGD, on the CPU.  Writes ``rank{r}.json`` under
``LAUNCH_OUT_DIR``."""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import distributed as dist  # noqa: E402
from paddle_tpu_torch import nn, optimizer  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402


def batches(n, B=16, seed=0):
    """``tests/test_localsgd.py``'s batches."""
    rng = np.random.RandomState(seed)
    w = rng.randn(6, 1).astype(np.float32)
    out = []
    for _ in range(n):
        xv = rng.randn(B, 6).astype(np.float32)
        out.append((xv, (xv @ w).astype(np.float32)))
    return out


def main():
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    pt.set_device("cpu")
    pt.seed(0)
    model = nn.Linear(6, 1)
    pt.seed(0)
    ref = nn.Linear(6, 1)
    opt = optimizer.SGD(0.1, parameters=model.parameters())
    ref_opt = optimizer.SGD(0.1, parameters=ref.parameters())
    half = 16 // world
    errs = []
    for xv, yv in batches(6):
        part = slice(rank * half, (rank + 1) * half)
        F.mse_loss(model(pt.to_tensor(xv[part])),
                   pt.to_tensor(yv[part])).backward()
        opt.step()
        opt.clear_grad()
        with pt.no_grad():
            for p in model.parameters():
                dist.all_reduce(p, op=dist.ReduceOp.AVG)
        F.mse_loss(ref(pt.to_tensor(xv)), pt.to_tensor(yv)).backward()
        ref_opt.step()
        ref_opt.clear_grad()
        errs.append(max(float((p._value - q._value).abs().max())
                        for p, q in zip(model.parameters(),
                                        ref.parameters())))
    # sync_params_buffers: rank 0's weights everywhere
    pt.seed(rank + 5)
    other = nn.Linear(6, 1)
    dist.sync_params_buffers(other)
    synced = other.weight.numpy().tolist()
    # DataParallel: each trainer's gradient of its half, averaged over
    # the trainers, is the full batch's
    dp = pt.DataParallel(other)
    xv, yv = batches(1, seed=1)[0]
    F.mse_loss(dp(pt.to_tensor(xv[part])), pt.to_tensor(yv[part])).backward()
    dp.apply_collective_grads()
    full = nn.Linear(6, 1)
    full.set_state_dict(other.state_dict())
    F.mse_loss(full(pt.to_tensor(xv)), pt.to_tensor(yv)).backward()
    dp_err = float((other.weight.grad._value
                    - full.weight.grad._value).abs().max())
    total = dist.all_reduce(pt.to_tensor(np.float32(rank + 1)))
    gathered = []
    dist.all_gather_object(gathered, {"rank": rank})
    out = {"rank": rank, "world": world, "sum": float(total._value),
           "max_abs_err": max(errs), "gathered": gathered,
           "synced": synced, "dp_grad_err": dp_err,
           "weight": model.weight.numpy().tolist(),
           "endpoint": os.environ.get("PADDLE_CURRENT_ENDPOINT"),
           "gloo": os.environ.get("PADDLE_GLOO_ENDPOINT")}
    with open(os.path.join(os.environ["LAUNCH_OUT_DIR"],
                           f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.gloo.shutdown()


if __name__ == "__main__":
    main()
