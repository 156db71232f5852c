"""Trainer / DeviceWorker stack: dataset-driven multi-thread training —
twin of ``paddle_tpu/distributed/fleet/trainer.py``.

Reference: framework/trainer.h:53 TrainerBase / :98 MultiTrainer (one
DeviceWorker thread per dataset reader), device_worker.h:150 DeviceWorker /
:240 HogwildWorker (lock-free concurrent TrainFiles loops sharing the
scope), driven from python by Executor.train_from_dataset
(fluid/executor.py train_from_dataset -> C++ trainer).

Shape: workers are threads; each drains its shard of the dataset and
calls a train function.  Dense math inside the train function runs
through torch (which releases the GIL in its kernels and while the card
computes); sparse embedding pulls/pushes hit the host SparseTable
concurrently — the Hogwild semantics (unsynchronized, last-writer-wins
row updates) are preserved exactly because the table is host memory
shared by all workers.  The dense parameters' gradients are shared
too: torch keeps one ``grad`` a parameter, where the reference gives
each thread its own scope.  So while two or more workers run,
``clear_grad`` zeroes a gradient in place instead of dropping it
(``tensor.shared_gradients``): an accumulation racing a clear then
loses part of an update, as hogwild allows, where a gradient set to
None under torch's accumulation would fail.  Workers that share a card
issue their work on the one current stream, so their launches are
ordered."""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ...tensor import shared_gradients


class DeviceWorker:
    """device_worker.h:150 — one thread's training loop."""

    def __init__(self, worker_id: int, train_func: Callable[..., Any],
                 fetch_period: int = 0,
                 fetch_handler: Optional[Callable] = None):
        self.worker_id = worker_id
        self.train_func = train_func
        self.fetch_period = fetch_period
        self.fetch_handler = fetch_handler
        self.batches = 0
        self.losses: List[float] = []
        self.error: Optional[BaseException] = None

    def train_from(self, batch_iter) -> None:
        """TrainFiles analog."""
        try:
            for batch in batch_iter:
                out = self.train_func(batch)
                self.batches += 1
                if out is not None:
                    arr = np.asarray(out)
                    if arr.size == 1:
                        self.losses.append(float(arr))
                    # non-scalar fetches (infer_from_dataset predictions)
                    # are the caller's to collect inside train_func
                if (self.fetch_period and self.fetch_handler
                        and self.batches % self.fetch_period == 0):
                    self.fetch_handler(self.worker_id, self.batches,
                                       self.losses[-1] if self.losses
                                       else None)
        except BaseException as e:  # noqa: BLE001 — surfaced by the trainer
            self.error = e


class HogwildWorker(DeviceWorker):
    """device_worker.h:240 — the lock-free worker.  Pair with a
    ``SparseTable(hogwild=True)``: its push path resolves slots under the
    structure lock only and then updates rows through the native scatter
    kernel (csrc ptpu_scatter_axpy) with the GIL RELEASED — so these
    worker threads genuinely race on shared rows, last-writer-wins, the
    reference's hogwild contract rather than a name-parity shell.  Dense
    math inside train_func releases the GIL in torch's kernels; the
    workers share the dense gradients without a lock, which
    ``MultiTrainer`` makes safe (the module docstring)."""


class MultiTrainer:
    """trainer.h:98 MultiTrainer: spawn one worker thread per dataset
    shard, join, surface errors and per-worker losses."""

    def __init__(self, dataset, train_func: Callable[..., Any],
                 thread_num: Optional[int] = None, fetch_period: int = 0,
                 fetch_handler: Optional[Callable] = None,
                 worker_cls=HogwildWorker):
        self.dataset = dataset
        self.thread_num = thread_num or getattr(dataset, "thread_num", 1)
        self.workers = [
            worker_cls(i, train_func, fetch_period, fetch_handler)
            for i in range(self.thread_num)
        ]

    def run(self) -> Dict[str, Any]:
        t0 = time.time()
        threads = []
        for w in self.workers:
            it = self.dataset.iter_batches(thread_id=w.worker_id,
                                           num_threads=self.thread_num)
            th = threading.Thread(target=w.train_from, args=(it,),
                                  name=f"hogwild-worker-{w.worker_id}",
                                  daemon=True)
            threads.append(th)
        with shared_gradients() if len(threads) > 1 \
                else contextlib.nullcontext():
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        for w in self.workers:
            if w.error is not None:
                raise RuntimeError(
                    f"worker {w.worker_id} failed") from w.error
        losses = [loss for w in self.workers for loss in w.losses]
        return {
            "batches": sum(w.batches for w in self.workers),
            "losses": losses,
            "per_worker_losses": [list(w.losses) for w in self.workers],
            "seconds": time.time() - t0,
        }


def train_from_dataset(dataset, train_func: Callable[..., Any],
                       thread_num: Optional[int] = None,
                       fetch_period: int = 0,
                       fetch_handler: Optional[Callable] = None,
                       ps_step: Optional[Callable] = None) -> Dict[str, Any]:
    """Functional entry (Executor.train_from_dataset analog for dygraph
    models): run `train_func(batch_dict) -> loss` over every batch of
    `dataset` with `thread_num` hogwild threads.

    ``ps_step``: called once per batch after train_func (single-thread
    mode only) — the Communicator.step() cadence hook for geo mode."""
    if ps_step is not None and (thread_num or dataset.thread_num) > 1:
        raise ValueError(
            "ps_step cadence is per-trainer, not per-thread — drive "
            "Communicator.step() from inside train_func for multi-thread "
            "hogwild runs")

    if ps_step is not None:
        inner = train_func

        def train_func(batch):  # noqa: F811 — deliberate wrap
            out = inner(batch)
            ps_step()
            return out

    return MultiTrainer(dataset, train_func, thread_num=thread_num,
                        fetch_period=fetch_period,
                        fetch_handler=fetch_handler).run()
