"""Host-resident sharded sparse table — twin of
``paddle_tpu/distributed/ps/table.py`` (host code on numpy; the same
arenas and rules).

Reference common_sparse_table.cc:
shard-structured storage ValueBlock/shard_num, initializers, rowwise
sgd/adagrad/adam rules applied at push time; large_scale_kv.h).

Rows are created lazily on first touch — a 1e9-row vocab costs nothing
until ids arrive.  Each shard is a dict id->slot plus growing numpy arenas
(values + per-slot optimizer accumulators); pulls/pushes are vectorized
gathers/scatters over the arenas."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ...framework.concurrency import OrderedLock
from ...io import native_feed

_RULES = ("sgd", "adagrad", "adam", "sum")


class _Shard:
    def __init__(self, dim, rule, init_fn, block=4096, dtype=np.float32):
        self.dim = dim
        self.rule = rule
        self.block = block
        self.dtype = dtype
        self.index: Dict[int, int] = {}
        self.values = np.zeros((0, dim), dtype)
        self.init_fn = init_fn
        if rule == "adagrad":
            self.g2 = np.zeros((0, dim), np.float32)
        elif rule == "adam":
            self.m = np.zeros((0, dim), np.float32)
            self.v = np.zeros((0, dim), np.float32)
            self.t = np.zeros((0,), np.int64)

    def _grow(self, n_needed):
        cap = self.values.shape[0]
        if n_needed <= cap:
            return
        # geometric growth: amortized O(N) arena copies
        new_cap = max(cap * 2, n_needed, self.block)
        grown = np.zeros((new_cap, self.dim), self.dtype)
        grown[:cap] = self.values
        self.values = grown

        def grow(arr, shape):
            out = np.zeros(shape, arr.dtype)
            out[: arr.shape[0]] = arr
            return out

        if self.rule == "adagrad":
            self.g2 = grow(self.g2, (new_cap, self.dim))
        elif self.rule == "adam":
            self.m = grow(self.m, (new_cap, self.dim))
            self.v = grow(self.v, (new_cap, self.dim))
            self.t = grow(self.t, (new_cap,))

    def slots_for(self, ids: np.ndarray, create: bool) -> np.ndarray:
        slots = np.empty(len(ids), np.int64)
        new_ids = []
        for i, gid in enumerate(ids):
            s = self.index.get(int(gid), -1)
            if s < 0 and create:
                s = len(self.index)
                self.index[int(gid)] = s
                new_ids.append(s)
            slots[i] = s
        if new_ids:
            self._grow(len(self.index))
            rows = self.init_fn((len(new_ids), self.dim)).astype(self.dtype)
            self.values[np.asarray(new_ids)] = rows
        return slots

    def pull(self, ids: np.ndarray, create=True) -> np.ndarray:
        slots = self.slots_for(ids, create)
        out = np.zeros((len(ids), self.dim), self.dtype)
        hit = slots >= 0
        out[hit] = self.values[slots[hit]]
        return out

    def push(self, ids: np.ndarray, grads: np.ndarray, lr: float,
             **hp) -> None:
        slots = self.slots_for(ids, create=True)
        # merge duplicate ids (sum, matching allreduce-of-sparse semantics)
        uniq, inv = np.unique(slots, return_inverse=True)
        g = np.zeros((len(uniq), self.dim), np.float32)
        np.add.at(g, inv, grads.astype(np.float32))
        if self.rule == "sum":
            self.values[uniq] += g.astype(self.dtype)
        elif self.rule == "sgd":
            self.values[uniq] -= (lr * g).astype(self.dtype)
        elif self.rule == "adagrad":
            eps = hp.get("epsilon", 1e-6)
            self.g2[uniq] += g * g
            self.values[uniq] -= (
                lr * g / (np.sqrt(self.g2[uniq]) + eps)).astype(self.dtype)
        elif self.rule == "adam":
            b1 = hp.get("beta1", 0.9)
            b2 = hp.get("beta2", 0.999)
            eps = hp.get("epsilon", 1e-8)
            self.t[uniq] += 1
            t = self.t[uniq][:, None].astype(np.float64)
            self.m[uniq] = b1 * self.m[uniq] + (1 - b1) * g
            self.v[uniq] = b2 * self.v[uniq] + (1 - b2) * g * g
            mhat = self.m[uniq] / (1 - b1 ** t)
            vhat = self.v[uniq] / (1 - b2 ** t)
            self.values[uniq] -= (
                lr * mhat / (np.sqrt(vhat) + eps)).astype(self.dtype)


class SparseTable:
    """Shard-partitioned sparse embedding table with rowwise optimization
    (common_sparse_table.cc analog; the pull/push surface mirrors
    brpc_ps_client.cc PullSparse/PushSparse)."""

    def __init__(self, dim: int, rule: str = "sgd", num_shards: int = 8,
                 initializer: Optional[str] = "uniform", init_scale=0.01,
                 seed: int = 0, dtype=np.float32, hogwild: bool = False,
                 **hyperparams):
        if hogwild and rule != "sgd":
            raise ValueError(
                f"hogwild=True requires rule='sgd' (got {rule!r}): "
                "stateful rowwise rules (adagrad/adam accumulators) need "
                "read-modify-write on optimizer state, which the "
                "lock-free path cannot provide")
        self.hogwild = hogwild
        if rule not in _RULES:
            raise ValueError(f"rule must be one of {_RULES}")
        rng = np.random.RandomState(seed)
        if initializer == "uniform":
            init_fn = lambda shape: rng.uniform(-init_scale, init_scale,
                                                shape)
        elif initializer == "normal":
            init_fn = lambda shape: rng.randn(*shape) * init_scale
        else:  # zeros
            init_fn = lambda shape: np.zeros(shape)
        self.dim = dim
        self.rule = rule
        self.hp = hyperparams
        self.num_shards = num_shards
        self._shards = [_Shard(dim, rule, init_fn, dtype=dtype)
                        for _ in range(num_shards)]
        # structure guard: slots_for's read-modify-write on the id index and
        # _grow's arena rebind are not atomic — PS server connection threads
        # and hogwild workers hit them concurrently.  Row UPDATES stay
        # hogwild (last-writer-wins) in spirit; only the index/arena
        # structure is serialized.
        self._lock = OrderedLock("ps.table")

    def _route(self, ids: np.ndarray):
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        shard_of = ids % self.num_shards
        return ids, shard_of

    def pull(self, ids, create: bool = True) -> np.ndarray:
        """ids [N] -> rows [N, dim].  With ``create`` (training pulls),
        unseen rows are initialized (reference PullSparse w/ initializer);
        with ``create=False`` (serving), unseen ids return zero rows and
        allocate nothing."""
        ids, shard_of = self._route(ids)
        out = np.zeros((len(ids), self.dim), self._shards[0].dtype)
        with self._lock:
            for s in range(self.num_shards):
                mask = shard_of == s
                if mask.any():
                    out[mask] = self._shards[s].pull(ids[mask],
                                                     create=create)
        return out

    def push(self, ids, grads, lr: float = 0.01) -> None:
        """Apply rowwise-optimizer updates for `grads` [N, dim] at `ids`
        (duplicates merged by summation — PushSparse).

        With ``hogwild=True`` and the sgd rule, the row math runs
        LOCK-FREE through the native scatter kernel with the GIL released
        (reference HogwildWorker, device_worker.h:240): worker threads
        update shared rows concurrently, duplicates accumulate in
        arrival order, races on a row are last-writer-wins, and a write
        that lands on a just-reallocated arena is lost — the hogwild
        contract.  Only slot allocation stays serialized (a torn index
        would be corruption, not a stale read)."""
        ids, shard_of = self._route(ids)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        if self.hogwild and self.rule == "sgd":
            per_shard = []
            with self._lock:  # structure only: id->slot + arena growth
                for s in range(self.num_shards):
                    mask = shard_of == s
                    if mask.any():
                        slots = self._shards[s].slots_for(ids[mask],
                                                          create=True)
                        per_shard.append((s, mask, slots))
            for s, mask, slots in per_shard:
                sh = self._shards[s]
                vals = sh.values  # keep the arena alive across the call
                if vals.dtype == np.float32:
                    native_feed.scatter_axpy(vals, slots, grads[mask], -lr)
                else:   # the native kernel takes f32 arenas only
                    np.add.at(vals, slots, (-lr * grads[mask]).astype(
                        vals.dtype))
            return
        with self._lock:
            for s in range(self.num_shards):
                mask = shard_of == s
                if mask.any():
                    self._shards[s].push(ids[mask], grads[mask], lr,
                                         **self.hp)

    def apply_deltas(self, ids, deltas) -> None:
        """Add weight deltas directly to rows (geo-communicator push —
        rule-independent: the local trainer already applied its optimizer)."""
        ids, shard_of = self._route(ids)
        deltas = np.asarray(deltas, np.float32).reshape(len(ids), self.dim)
        with self._lock:
            for s in range(self.num_shards):
                mask = shard_of == s
                if mask.any():
                    sh = self._shards[s]
                    slots = sh.slots_for(ids[mask], create=True)
                    np.add.at(sh.values, slots,
                              deltas[mask].astype(sh.dtype))

    @property
    def size(self) -> int:
        """Number of materialized rows (<< vocab for sparse workloads)."""
        return sum(len(s.index) for s in self._shards)

    _ACC_FIELDS = {"adagrad": ("g2",), "adam": ("m", "v", "t")}

    def state_dict(self):
        """Rows AND rowwise-optimizer accumulators (a resume that re-zeroed
        adam/adagrad state would jump the effective step size)."""
        fields = self._ACC_FIELDS.get(self.rule, ())
        ids_parts, row_parts = [], []
        acc_parts = {f: [] for f in fields}
        with self._lock:
            for s in self._shards:
                if not s.index:
                    continue
                gids = np.fromiter(s.index.keys(), np.int64, len(s.index))
                slots = np.fromiter(s.index.values(), np.int64,
                                    len(s.index))
                ids_parts.append(gids)
                row_parts.append(s.values[slots])
                for f in fields:
                    acc_parts[f].append(getattr(s, f)[slots])
        if not ids_parts:
            out = {"ids": np.zeros((0,), np.int64),
                   "rows": np.zeros((0, self.dim), np.float32)}
            for f in fields:
                out[f] = np.zeros((0,), np.float32)
            return out
        out = {"ids": np.concatenate(ids_parts),
               "rows": np.concatenate(row_parts)}
        for f in fields:
            out[f] = np.concatenate(acc_parts[f])
        return out

    def set_state_dict(self, d):
        if not len(d["ids"]):
            return
        fields = self._ACC_FIELDS.get(self.rule, ())
        ids, shard_of = self._route(d["ids"])
        with self._lock:
            for s in range(self.num_shards):
                mask = shard_of == s
                if mask.any():
                    slots = self._shards[s].slots_for(ids[mask],
                                                      create=True)
                    self._shards[s].values[slots] = d["rows"][mask]
                    for f in fields:
                        if f in d:
                            getattr(self._shards[s], f)[slots] = d[f][mask]
