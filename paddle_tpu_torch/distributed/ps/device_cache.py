"""Device-resident embedding cache over a host SparseTable — twin of
``paddle_tpu/distributed/ps/device_cache.py``.

Reference analog: framework/fleet/heter_ps/ (hashtable.h GPU hash table,
heter_comm.h) — the reference keeps hot embedding rows in GPU memory and
falls back to the CPU parameter server for the long tail.  The cache is
one fixed [cache_rows, dim] tensor on the card (the CPU when the caller
names it); a host dict maps id->slot with second-chance eviction.  The
gathers and scatters are ATen's ``index_select`` / ``index_copy_`` (the
JAX package's are ``jnp`` indexing, XLA's job: no TPU kernel lies on
this path).  Every cache operation is issued on the stream that was
current when the cache was made, so a scatter from one hogwild thread is
ordered against another thread's gather.  A training step's pull
becomes ONE device gather over the cache (misses are fetched from the
host/remote table in a single batched pull and scattered into evicted
slots); pushes apply the rowwise optimizer on the host table and refresh
the cached copies in one scatter.

Locking (the JAX package's lock discipline; witness names
``ps.device_cache_io`` > ``ps.device_cache`` > ``ps.table`` >
``ps.conn``):

- ``_lock`` guards the cache STRUCTURE (slot index, ref bits, device
  array) and is held only for host/device bookkeeping — never across a
  backing-table call.  The backing table may be a RemoteSparseTable (a
  network round-trip per pull/push), and the pre-fix single-lock design
  stalled every reader of RESIDENT rows behind any one miss fetch or
  push RPC.
- ``_io_lock`` serializes the paths that TALK TO THE BACKING TABLE and
  then mutate the cache from the response (miss fills, push/delta
  refresh, state_dict load).  Holding it across the RPC is the point —
  with writers and miss-fills mutually excluded, a fill can never
  install rows made stale by a concurrent push (the push's refresh runs
  strictly before or strictly after the fill's install, and a refresh
  re-scatters every then-resident id).  All-hit pulls take only
  ``_lock`` and proceed while an RPC is in flight.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...framework.concurrency import OrderedLock, OrderedRLock
from ...framework.place import to_device


class DeviceCachedTable:
    """SparseTable-shaped adapter: same pull/push surface, device-cached.

    Thread-safe like SparseTable (hogwild workers / PS connection threads
    share it).  `hit_rate` exposes cache effectiveness; with CTR skew
    (zipfian ids) steady-state hit rates are high and the per-step host
    traffic drops to the miss tail — the heter_ps design point."""

    def __init__(self, table, cache_rows: int = 1 << 16,
                 dtype=torch.float32, device=None):
        self.table = table
        self.dim = table.dim
        self.rule = getattr(table, "rule", "sgd")
        self.cache_rows = int(cache_rows)
        self.device = to_device(device)
        self._cache = torch.zeros((self.cache_rows, self.dim), dtype=dtype,
                                  device=self.device)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._slot_of: Dict[int, int] = {}
        self._id_at = np.full((self.cache_rows,), -1, np.int64)
        self._ref = np.zeros((self.cache_rows,), bool)  # second chance
        self._hand = 0
        self._hits = 0
        self._lookups = 0
        self._lock = OrderedRLock("ps.device_cache")
        self._io_lock = OrderedLock("ps.device_cache_io")

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _index(self, slots: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(slots, np.int64)).to(
            self.device)

    def _gather_host(self, slots: np.ndarray) -> np.ndarray:
        """The cached rows at ``slots`` as a host array (a sync on the
        card).  Caller holds _lock."""
        with self._on_stream():
            return self._cache.index_select(0, self._index(slots)).cpu(
            ).numpy()

    def _scatter(self, slots: np.ndarray, rows: np.ndarray) -> None:
        """``cache[slots] = rows``.  Caller holds _lock."""
        with self._on_stream():
            self._cache.index_copy_(0, self._index(slots), torch.from_numpy(
                np.ascontiguousarray(rows)).to(self.device,
                                               self._cache.dtype))

    # -- eviction ------------------------------------------------------------

    def _grab_slot(self, pinned) -> int:
        """Second-chance (clock) eviction over the slot ring.  `pinned`
        slots belong to the in-flight batch and must not be evicted
        (evicting a row pulled moments ago in the SAME batch would hand
        its slot to another id and corrupt the gather).  Returns -1 when
        every slot is pinned — the caller serves the row uncached.
        Caller holds BOTH _io_lock and _lock (evictions are structure
        mutations, serialized under the io lock)."""
        scanned = 0
        limit = 2 * self.cache_rows
        while True:
            s = self._hand
            self._hand = (self._hand + 1) % self.cache_rows
            scanned += 1
            if s in pinned:
                if scanned > limit:
                    return -1
                continue
            if self._ref[s]:
                self._ref[s] = False
                continue
            old = self._id_at[s]
            if old >= 0:
                self._slot_of.pop(int(old), None)
            return s

    # -- residency -----------------------------------------------------------

    def _lookup_locked(self, ids: np.ndarray, count: bool
                       ) -> Tuple[np.ndarray, List[int]]:
        """Resident slots for `ids` ([N], -1 = miss) + miss positions;
        marks resident rows referenced.  Caller holds _lock."""
        slots = np.empty(len(ids), np.int64)
        miss_idx: List[int] = []
        for i, gid in enumerate(ids):
            s = self._slot_of.get(int(gid), -1)
            if s >= 0:
                self._ref[s] = True
            else:
                miss_idx.append(i)
            slots[i] = s
        if count:
            # accounting happens ONCE per pull (the first lookup): the
            # post-fetch re-validation must not inflate the denominator
            self._lookups += len(ids)
            self._hits += len(ids) - len(miss_idx)
        return slots, miss_idx

    def _fill_misses(self, ids: np.ndarray, create: bool
                     ) -> Tuple[np.ndarray, Optional[np.ndarray], dict]:
        """Make `ids` cache-resident where capacity allows, fetching the
        misses from the backing table WITHOUT holding the cache lock.

        Returns (slots [N] with -1 for uncached overflow rows,
        overflow_rows_by_unique_index or None, seen: id -> unique idx).
        Caller holds _io_lock (so no concurrent fill/push/evict can
        interleave between the fetch and the install) but NOT _lock.
        """
        with self._lock:
            slots, miss_idx = self._lookup_locked(ids, count=False)
            uniq_ids: List[int] = []
            seen: Dict[int, int] = {}
            for i in miss_idx:
                gid = int(ids[i])
                if gid not in seen:
                    seen[gid] = len(uniq_ids)
                    uniq_ids.append(gid)
        if not uniq_ids:
            return slots, None, {}
        # the RPC: cache lock NOT held — concurrent all-hit pulls keep
        # streaming; _io_lock (held by the caller) is what keeps a
        # racing push from making these rows stale before they land
        rows = self.table.pull(np.asarray(uniq_ids, np.int64),  # analyze: allow[lock-discipline] io serialization point: _io_lock intentionally spans fetch+install (see module docstring)
                               create=create)
        with self._lock:
            pinned = {int(s) for s in slots if s >= 0}
            uniq_slots = np.empty(len(uniq_ids), np.int64)
            for j, gid in enumerate(uniq_ids):
                s = self._grab_slot(pinned)
                if s >= 0:
                    self._slot_of[gid] = s
                    self._id_at[s] = gid
                    self._ref[s] = True
                    pinned.add(s)
                uniq_slots[j] = s
            cacheable = uniq_slots >= 0
            if cacheable.any():
                self._scatter(uniq_slots[cacheable], rows[cacheable])
            for i in miss_idx:
                slots[i] = uniq_slots[seen[int(ids[i])]]
        overflow = rows if (~cacheable).any() else None
        return slots, overflow, seen

    # -- pull/push -----------------------------------------------------------

    def pull(self, ids, create: bool = True) -> np.ndarray:
        """Rows for `ids` as a HOST array (SparseTable-compatible)."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        with self._lock:
            slots, miss_idx = self._lookup_locked(ids, count=True)
            if not miss_idx:               # all resident: no RPC, no io lock
                return self._gather_host(slots)
        with self._io_lock:
            slots, overflow, seen = self._fill_misses(ids, create)
            with self._lock:
                out = self._gather_host(np.maximum(slots, 0))
            if overflow is not None:
                for i in np.nonzero(slots < 0)[0]:
                    out[i] = overflow[seen[int(ids[i])]]
            return out

    def pull_device(self, ids):
        """Rows for `ids` as the DEVICE gather over the cache — no host
        copy (the embedding layer's per-step read): a tensor on the
        cache's device.  Assembles on the host only when the batch's
        unique ids overflow the cache."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        with self._lock:
            slots, miss_idx = self._lookup_locked(ids, count=True)
            if not miss_idx:
                with self._on_stream():
                    return self._cache.index_select(0, self._index(slots))
        with self._io_lock:
            slots, overflow, seen = self._fill_misses(ids, create=True)
            with self._lock:
                if overflow is None:
                    with self._on_stream():
                        return self._cache.index_select(
                            0, self._index(slots))
                out = self._gather_host(np.maximum(slots, 0))
            for i in np.nonzero(slots < 0)[0]:
                out[i] = overflow[seen[int(ids[i])]]
            return torch.from_numpy(out).to(self.device)

    def _refresh(self, ids: np.ndarray) -> None:
        """Re-sync cached copies of `ids` from the backing table — ONE
        batched pull of only the ids actually resident (a cold-cache push
        of 16k ids refreshes nothing and costs no extra RPC).  Caller
        holds _io_lock but NOT _lock."""
        with self._lock:
            live = [(int(g), self._slot_of[int(g)]) for g in ids
                    if int(g) in self._slot_of]
        if not live:
            return
        live_ids = np.asarray([g for g, _ in live], np.int64)
        fresh = self.table.pull(live_ids, create=False)  # analyze: allow[lock-discipline] io serialization point: _io_lock intentionally spans fetch+scatter (see module docstring)
        with self._lock:
            # slots cannot have moved (installs/evictions need _io_lock,
            # which we hold) — scatter unconditionally
            self._scatter(np.asarray([s for _, s in live], np.int64), fresh)

    def push(self, ids, grads, lr: float = 0.01) -> None:
        """Host-table rowwise update, then refresh the cached copies (the
        cache never RETAINS a stale row past a completed push).  The
        cache lock is never held across the table RPCs — readers of
        resident rows proceed while the update is in flight."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        with self._io_lock:
            self.table.push(ids, grads, lr=lr)  # analyze: allow[lock-discipline] io serialization point: the cache lock is NOT held here (see module docstring)
            self._refresh(ids)

    def apply_deltas(self, ids, deltas) -> None:
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        with self._io_lock:
            self.table.apply_deltas(ids, deltas)  # analyze: allow[lock-discipline] io serialization point: the cache lock is NOT held here (see module docstring)
            self._refresh(ids)

    # -- introspection -------------------------------------------------------

    @property
    def size(self) -> int:
        return self.table.size

    @property
    def cached_rows(self) -> int:
        return len(self._slot_of)

    @property
    def hit_rate(self) -> float:
        return self._hits / self._lookups if self._lookups else 0.0

    def state_dict(self):
        return self.table.state_dict()

    def set_state_dict(self, d):
        with self._io_lock:
            self.table.set_state_dict(d)
            with self._lock:
                # drop the cache: cached copies may be stale vs loaded
                # state
                self._slot_of.clear()
                self._id_at[:] = -1
                self._ref[:] = False
