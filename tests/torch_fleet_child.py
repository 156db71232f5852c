"""Child processes of the port's fleet tests, on the CPU:

- ``shuffle OUT``: a trainer of ``tests/test_torch_dataset_trainer.py``'s
  global-shuffle test, started by ``python -m
  paddle_tpu_torch.distributed.launch``: 40 records of its own id range,
  ``InMemoryDataset.global_shuffle`` over the host backend; writes
  ``shuffle{rank}.json`` (the ids it holds after the shuffle);
- ``server``: a PS server process (``TRAINING_ROLE=PSERVER``,
  ``PADDLE_PSERVER_ID``): serves until a trainer sends stop;
- ``trainer OUT``: a trainer of ``tests/test_torch_ps_service.py``'s geo
  cluster (the port's twin of ``tests/dist_ps_trainer_runner.py``): CTR
  training through ``RemoteSparseTable`` shards on the server processes,
  then rank 0 pulls rank 1's rows; writes ``trainer{rank}.json``.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import distributed as dist  # noqa: E402
from paddle_tpu_torch import nn, optimizer  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.ps import runtime as ps_runtime  # noqa
from paddle_tpu_torch.io.multislot import Slot, write_multislot_file  # noqa
from paddle_tpu_torch.nn import functional as F  # noqa: E402

VOCAB = 400
EMB_DIM = 8


def shuffle(out):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    dist.init_parallel_env()
    slots = [Slot("ids", dtype="int64")]
    path = os.path.join(out, f"rank{rank}.txt")
    write_multislot_file(path, [{"ids": [rank * 1000 + i]}
                                for i in range(40)], slots)
    ds = fleet.InMemoryDataset()
    ds.set_slots(slots)
    ds.set_filelist([path])
    ds.set_batch_size(1000)
    ds.load_into_memory()
    ds.set_shuffle_seed(42)
    ds.global_shuffle()
    with open(os.path.join(out, f"shuffle{rank}.json"), "w") as f:
        json.dump({"rank": rank,
                   "ids": [int(r.slots["ids"][0]) for r in ds._records]}, f)
    dist.gloo.shutdown()


def server():
    fleet.init(fleet.PaddleCloudRoleMaker())
    assert fleet.is_server()
    fleet.init_server()
    print("SERVER READY", flush=True)
    fleet.run_server()
    print("SERVER STOPPED", flush=True)


def trainer(out):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    pt.set_device("cpu")
    strategy = fleet.DistributedStrategy()
    strategy.a_sync = True
    strategy.a_sync_configs.k_steps = 4
    fleet.init(fleet.PaddleCloudRoleMaker(), strategy=strategy)
    assert fleet.is_worker()
    fleet.init_worker()
    emb = fleet.sparse_embedding("ctr", EMB_DIM, rule="sgd", lr=0.5)
    pt.seed(7 + rank)
    head = nn.Linear(EMB_DIM, 1)
    opt = optimizer.SGD(learning_rate=0.2, parameters=head.parameters())
    # disjoint id ranges per trainer: rank 0 later pulls rank 1's rows
    rng = np.random.RandomState(100 + rank)
    half, base = VOCAB // 4, rank * (VOCAB // 2)
    losses = []
    for _ in range(60):
        ids = base + rng.randint(0, half, size=(16, 3))
        label = (ids.min(axis=1, keepdims=True) < base + half // 4) \
            .astype(np.float32)
        pooled = emb(pt.to_tensor(ids)).sum(axis=1)
        loss = F.binary_cross_entropy_with_logits(head(pooled),
                                                  pt.to_tensor(label))
        loss.backward()
        opt.step()
        opt.clear_grad()
        emb.step()
        losses.append(float(loss.numpy()))
    fleet.stop_worker()               # flush the geo deltas
    dist.collective.barrier()         # both trainers fully flushed
    res = {"rank": rank, "losses": losses}
    if rank == 0:
        client = ps_runtime.get_client()
        res["table_size"] = client.table_size("ctr")
        probe = np.arange(VOCAB // 2, VOCAB)
        rows = client.pull_sparse("ctr", probe, create=False)
        res["other_rows_nonzero"] = bool(np.abs(rows).sum() > 0)
    dist.collective.barrier()
    if rank == 0:
        ps_runtime.shutdown_servers()
    with open(os.path.join(out, f"trainer{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.gloo.shutdown()


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "server":
        server()
    else:
        {"shuffle": shuffle, "trainer": trainer}[mode](sys.argv[2])
