"""SparseEmbedding: device-light embedding over a host SparseTable — twin
of ``paddle_tpu/distributed/ps/embedding.py`` (reference: the distributed
lookup_table path — operators/lookup_table_op + parameter_prefetch.cc
pull, push via communicator; python paddle.static.nn.sparse_embedding).

Per step: unique(batch ids) on the host -> table.pull -> [n_unique, dim]
rows on the device -> gather by the inverse index (differentiable) ->
a backward hook hands the dense [n_unique, dim] row gradient to the
Communicator.  The device never materializes [vocab, dim].

Difference by design: where the table is a ``DeviceCachedTable``, the
layer is training and no geo overlay applies, the rows come from the
cache's ``pull_device`` (a gather on the card, the same values) instead
of ``pull``'s host round trip, which the JAX package takes.

Syncs the design has: ids on the card are read back for ``np.unique``,
the inverse index (and host rows) are uploaded, and the hook reads the
row gradient back for the push.  On the card the gather's backward
sums duplicate ids with atomics, so the row gradient is not bit-stable
from run to run."""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ...framework.place import to_device
from ...nn.layer import Layer
from ...ops.dispatch import apply
from ...tensor import Tensor
from .communicator import Communicator
from .table import SparseTable


class SparseEmbedding(Layer):
    def __init__(self, dim: int, table: SparseTable = None,
                 communicator: Communicator = None, rule: str = "sgd",
                 lr: float = 0.01, mode: str = "sync", k_steps: int = 1,
                 device=None, **table_kw):
        super().__init__()
        self.table = table or SparseTable(dim, rule=rule, **table_kw)
        self.communicator = communicator or Communicator(
            self.table, mode=mode, k_steps=k_steps, lr=lr)
        self.dim = dim
        self.device = (self.table.device if hasattr(self.table, "device")
                       and device is None else to_device(device))
        self._stats_lock = threading.Lock()
        self.reset_stats()

    def reset_stats(self):
        """Zero the per-layer counters: forward calls and the host
        seconds in the pulls and in the pushes (the hook)."""
        with self._stats_lock:
            self.stats = {"calls": 0, "pull_s": 0.0, "push_s": 0.0}

    def _count(self, **delta):
        with self._stats_lock:
            for k, v in delta.items():
                self.stats[k] += v

    def _ids(self, ids) -> np.ndarray:
        v = ids._value if isinstance(ids, Tensor) else ids
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    def _rows(self, uids: np.ndarray) -> torch.Tensor:
        comm = self.communicator
        if (self.training and comm.mode != "geo"
                and hasattr(self.table, "pull_device")):
            return self.table.pull_device(uids)
        rows = comm.apply_overlay(uids,
                                  self.table.pull(uids,
                                                  create=self.training))
        return torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)

    def forward(self, ids):
        ids_np = self._ids(ids)
        shape = ids_np.shape
        uids, inverse = np.unique(ids_np.reshape(-1), return_inverse=True)
        t0 = time.perf_counter()
        rows = Tensor(self._rows(uids), stop_gradient=not self.training)
        self._count(calls=1, pull_s=time.perf_counter() - t0)
        inv = torch.from_numpy(inverse.reshape(-1).astype(np.int64)).to(
            self.device)

        if self.training:
            comm = self.communicator

            def push_hook(grad):
                t0 = time.perf_counter()
                comm.on_gradient(uids, grad._value.detach().cpu().numpy())
                self._count(push_s=time.perf_counter() - t0)
                return grad

            rows.register_hook(push_hook)

        def gather(r, idx):
            return r.index_select(0, idx).reshape(shape + (self.dim,))

        return apply("sparse_embedding_lookup", gather, rows, inv)

    def step(self):
        """Advance the communicator (geo flush cadence)."""
        self.communicator.step()
