"""Gradient communicator — twin of
``paddle_tpu/distributed/ps/communicator.py`` (host code on numpy).

Sync / async / geo merge policies (reference
service/communicator.cc — AsyncCommunicator:(send queue, merge add),
GeoCommunicator:(local training + k-step weight-delta push),
SyncCommunicator; selected by the fleet DistributedStrategy a_sync /
a_sync_configs.k_steps flags, distributed_strategy.proto:108-118)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from .table import SparseTable


class Communicator:
    """Applies embedding gradients to a SparseTable under a merge policy.

    mode='sync'  : push immediately (barrier per step — the k=0 case)
    mode='async' : push immediately, no barrier semantics (single process
                   collapses to sync; the distinction matters cross-host)
    mode='geo'   : TRAIN LOCALLY every step (an SGD overlay on the pulled
                   rows, so the trainer sees its own updates immediately)
                   and push the accumulated WEIGHT DELTAS to the global
                   table every `k_steps` (reference GeoCommunicator — the
                   table receives deltas, not gradients)
    """

    def __init__(self, table: SparseTable, mode: str = "sync",
                 k_steps: int = 1, lr: float = 0.01,
                 use_async_queue: bool = False):
        if mode not in ("sync", "async", "geo"):
            raise ValueError(f"unknown communicator mode {mode!r}")
        if mode == "geo" and k_steps < 1:
            raise ValueError("geo mode requires k_steps >= 1")
        self._async_q = None
        if use_async_queue:
            if mode != "async":
                raise ValueError("use_async_queue requires mode='async'")
            from .service import AsyncPushQueue

            self._async_q = AsyncPushQueue(table)
        self.table = table
        self.mode = mode
        self.k_steps = k_steps
        self.lr = lr
        self._step = 0
        # pending weight deltas as a vectorized mini-table: id -> slot into
        # a growing arena (a CTR batch carries 1e4-1e5 unique ids per step;
        # per-id Python dict arithmetic was the r3 weak #5 bottleneck)
        self._delta_index: Dict[int, int] = {}
        self._delta_rows = np.zeros((0, table.dim), np.float32)

    def _delta_slots(self, ids: np.ndarray) -> np.ndarray:
        """Slots for `ids` in the delta arena, creating rows as needed."""
        idx = self._delta_index
        slots = np.fromiter((idx.get(int(g), -1) for g in ids), np.int64,
                            len(ids))
        missing = slots < 0
        if missing.any():
            # setdefault + read-back: duplicate new ids in one batch must
            # share ONE slot (an arange assignment would orphan rows and
            # alias later ids onto them)
            for g in ids[missing]:
                idx.setdefault(int(g), len(idx))
            cap = self._delta_rows.shape[0]
            if len(idx) > cap:
                grown = np.zeros((max(cap * 2, len(idx), 1024),
                                  self.table.dim), np.float32)
                grown[:cap] = self._delta_rows
                self._delta_rows = grown
            slots[missing] = np.fromiter(
                (idx[int(g)] for g in ids[missing]), np.int64,
                int(missing.sum()))
        return slots

    def apply_overlay(self, ids: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Geo: overlay the local (not-yet-pushed) deltas onto pulled rows
        so local training sees its own updates between flushes.  One
        vectorized gather — no per-id Python."""
        if self.mode != "geo" or not self._delta_index:
            return rows
        ids = np.asarray(ids).reshape(-1)
        idx = self._delta_index
        slots = np.fromiter((idx.get(int(g), -1) for g in ids), np.int64,
                            len(ids))
        hit = slots >= 0
        if not hit.any():
            return rows
        out = rows.copy()
        out[hit] += self._delta_rows[slots[hit]]
        return out

    def on_gradient(self, ids, grads) -> None:
        """Called with the batch's unique ids + their dense grads."""
        ids = np.asarray(ids).reshape(-1)
        grads = np.asarray(grads, np.float32)
        if self.mode in ("sync", "async"):
            if self._async_q is not None:
                # AsyncCommunicator send-queue: the trainer never blocks on
                # the RPC; the drain thread pushes in arrival order
                self._async_q.put(ids, grads, self.lr)
            else:
                self.table.push(ids, grads, lr=self.lr)
            return
        # geo: local SGD step — accumulate weight deltas, one scatter-add
        slots = self._delta_slots(ids)
        np.add.at(self._delta_rows, slots, -self.lr * grads)

    def step(self) -> None:
        """Advance the trainer step; geo mode flushes every k_steps."""
        self._step += 1
        if self.mode == "geo" and self._step % self.k_steps == 0:
            self.flush()

    def stop(self) -> None:
        """Communicator::Stop — flush and terminate the drain thread."""
        self.flush()
        if self._async_q is not None:
            self._async_q.stop()
            self._async_q = None

    def flush(self) -> None:
        """Drain the async queue / push accumulated weight deltas (geo)."""
        if self._async_q is not None:
            self._async_q.flush()
        if not self._delta_index:
            return
        n = len(self._delta_index)
        ids = np.fromiter(self._delta_index.keys(), np.int64, n)
        deltas = self._delta_rows[
            np.fromiter(self._delta_index.values(), np.int64, n)]
        self._delta_index = {}
        self._delta_rows = np.zeros((0, self.table.dim), np.float32)
        self.table.apply_deltas(ids, deltas)
