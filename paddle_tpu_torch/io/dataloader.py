"""DataLoader — twin of ``paddle_tpu/io/dataloader.py``.

Batches are collated in numpy and handed out as port ``Tensor``s on the
CPU (float64 arrays as float32), in the sampler's order, whatever the
feed path:

1. **Array path**: a ``TensorDataset`` of arrays or Tensors with the
   default collate is gathered a batch at a time with numpy fancy
   indexing (uint8 columns scaled to f32 by 1/255) — the JAX package's
   own fallback of its native gather (``io/native_feed.py``, not
   ported).
2. **Process workers** (``num_workers > 0``, ``use_shared_memory``):
   worker processes fetch and collate, and ship each batch through POSIX
   shared memory; a bounded window of batches is in flight.  Workers
   never touch CUDA.  The start method is ``fork`` while this process
   has not initialised CUDA, and ``forkserver`` once it has (a fork of a
   process holding a CUDA context is not safe; the fork server is a
   fresh process that never made one), in which case the dataset and
   ``collate_fn`` must be picklable.
3. **Thread workers**: the fallback (``use_shared_memory=False``).

:func:`prefetch_to_device` stages the next batches onto the card while
the current step runs: each Tensor is copied into pinned host memory,
then to the device with a ``non_blocking`` copy on a side stream; an
event joins that stream to the compute stream before the batch is handed
out.  Its default device is the card.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import time

import numpy as np
import torch

from ..tensor import Tensor
from .dataset import IterableDataset, TensorDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "prefetch_to_device"]


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, Tensor):
        return np.stack([b.numpy() for b in batch])
    if isinstance(sample, torch.Tensor):
        return np.stack([b.detach().cpu().numpy() for b in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    return np.asarray(batch)


def _to_tensor_tree(obj):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensor_tree(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_tensor_tree(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        if obj.dtype == np.float64:
            obj = obj.astype(np.float32)
        if obj.dtype == np.object_ or obj.dtype.kind in "US":
            return obj
        return Tensor(torch.from_numpy(np.ascontiguousarray(obj)))
    return obj


def _as_list(out):
    return list(out) if isinstance(out, tuple) else out


_SENTINEL = object()


def _dataset_arrays(ds):
    """numpy views of a TensorDataset's columns, or None."""
    if not isinstance(ds, TensorDataset):
        return None
    cols = []
    for t in ds.tensors:
        if isinstance(t, Tensor):
            cols.append(t.numpy())
        elif isinstance(t, torch.Tensor):
            cols.append(t.detach().cpu().numpy())
        elif isinstance(t, np.ndarray):
            cols.append(t)
        else:
            return None
    return cols


class _ArrayIter:
    """Feed path 1: a whole batch gathered by fancy indexing."""

    def __init__(self, loader, cols):
        self._cols = [np.ascontiguousarray(c) for c in cols]
        self._batches = iter(loader.batch_sampler)

    def __iter__(self):
        return self

    def __next__(self):
        idxs = np.asarray(next(self._batches), np.int64)
        out = []
        for c in self._cols:
            batch = c[idxs]
            if c.dtype == np.uint8:
                batch = batch.astype(np.float32) * (1.0 / 255.0)
            out.append(batch)
        return _to_tensor_tree(out)


def _mp_worker(dataset, collate_fn, index_q, result_q, use_shm,
               worker_init_fn, worker_id):
    """Worker process body: lives for the pool's lifetime; a bad sample
    reports an error for ITS batch and the worker keeps serving."""
    from multiprocessing import shared_memory

    if worker_init_fn is not None:
        try:
            worker_init_fn(worker_id)
        except Exception as e:
            result_q.put((("__init__", worker_id), "error", repr(e)))
            return
    while True:
        item = index_q.get()
        if item is None:
            return
        i, idxs = item  # i = (epoch, index) tag, echoed back verbatim
        try:
            flat, spec = _flatten_np(collate_fn([dataset[j] for j in idxs]))
            if use_shm:
                blocks = []
                for arr in flat:
                    arr = np.ascontiguousarray(arr)
                    shm = shared_memory.SharedMemory(create=True,
                                                     size=max(arr.nbytes, 1))
                    np.ndarray(arr.shape, arr.dtype,
                               buffer=shm.buf)[...] = arr
                    blocks.append((shm.name, arr.shape, arr.dtype.str))
                    shm.close()
                result_q.put((i, "shm", (blocks, spec)))
            else:
                result_q.put((i, "pickle", (flat, spec)))
        except Exception as e:  # report, but keep the worker alive
            result_q.put((i, "error", repr(e)))


def _flatten_np(batch):
    """A collated batch (nested list/tuple/dict of arrays) as (arrays,
    spec) for the shared-memory transport."""
    flat = []

    def go(x):
        if isinstance(x, (list, tuple)):
            return ("seq", type(x).__name__, [go(v) for v in x])
        if isinstance(x, dict):
            return ("dict", sorted(x), [go(x[k]) for k in sorted(x)])
        if isinstance(x, Tensor):
            x = x.numpy()
        elif isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        flat.append(np.asarray(x))
        return ("leaf", len(flat) - 1, None)

    return flat, go(batch)


def _unflatten_np(flat, spec):
    kind, a, b = spec
    if kind == "leaf":
        return flat[a]
    if kind == "seq":
        seq = [_unflatten_np(flat, s) for s in b]
        return tuple(seq) if a == "tuple" else seq
    return {k: _unflatten_np(flat, s) for k, s in zip(a, b)}


def _discard_result(kind, payload):
    """Free the shared memory of a result that will never be consumed."""
    if kind != "shm":
        return
    from multiprocessing import shared_memory

    for name, _shape, _dtype in payload[0]:
        try:
            shm = shared_memory.SharedMemory(name=name)
            shm.close()
            shm.unlink()
        except Exception:
            pass


def _start_method() -> str:
    """``fork`` until this process has a CUDA context, then
    ``forkserver``."""
    return "forkserver" if torch.cuda.is_initialized() else "fork"


class _WorkerPool:
    """Worker processes + shared-memory transport, reusable across epochs
    (``persistent_workers``) with a bounded in-flight window."""

    def __init__(self, loader):
        ctx = mp.get_context(_start_method())
        self.n_workers = max(1, loader.num_workers)
        self.capacity = max(2, loader.prefetch_factor) * self.n_workers
        self._index_q = ctx.Queue()
        self._result_q = ctx.Queue(maxsize=self.capacity + self.n_workers)
        self._procs = [
            ctx.Process(target=_mp_worker,
                        args=(loader.dataset, loader.collate_fn,
                              self._index_q, self._result_q,
                              loader.use_shared_memory,
                              loader.worker_init_fn, wid),
                        daemon=True)
            for wid in range(self.n_workers)]
        for p in self._procs:
            p.start()
        self.alive = True
        self.epoch = 0

    def submit(self, i, idxs):
        self._index_q.put((i, list(idxs)))

    def get(self, timeout):
        deadline = None if not timeout else time.monotonic() + timeout
        while True:
            try:
                return self._result_q.get(timeout=1.0)
            except queue.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    raise RuntimeError(
                        f"DataLoader timed out after {timeout}s waiting "
                        "for a worker batch (timeout= parameter)")
                if not any(p.is_alive() for p in self._procs):
                    raise RuntimeError(
                        "all DataLoader workers died (did worker_init_fn "
                        "or the dataset crash the processes?)")

    def _drain(self):
        while True:
            try:
                _tag, kind, payload = self._result_q.get_nowait()
            except queue.Empty:
                return
            _discard_result(kind, payload)

    def shutdown(self):
        if not self.alive:
            return
        self.alive = False
        for _ in self._procs:
            try:
                self._index_q.put(None)
            except Exception:
                pass
        self._drain()
        for p in self._procs:
            p.join(timeout=1)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=1)
        self._drain()

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


class _ProcessIter:
    """One epoch over a _WorkerPool: indices stream into the pool as
    results are consumed (window = pool.capacity)."""

    def __init__(self, loader, pool):
        self.loader = loader
        self.pool = pool
        pool.epoch += 1
        self._epoch = pool.epoch
        self._batches = list(iter(loader.batch_sampler))
        self._n_batches = len(self._batches)
        self._sent = 0
        self._next_out = 0
        self._pending = {}
        while self._sent < min(pool.capacity, self._n_batches):
            pool.submit((self._epoch, self._sent), self._batches[self._sent])
            self._sent += 1

    def __iter__(self):
        return self

    def __next__(self):
        from multiprocessing import shared_memory

        if self._next_out >= self._n_batches:
            if not self.loader.persistent_workers:
                self.pool.shutdown()
            raise StopIteration
        while self._next_out not in self._pending:
            tag, kind, payload = self.pool.get(self.loader.timeout)
            epoch, i = tag
            if epoch == "__init__":
                self.pool.shutdown()
                raise RuntimeError(
                    f"DataLoader worker_init_fn failed in worker {i}: "
                    f"{payload}")
            if epoch != self._epoch:
                _discard_result(kind, payload)  # an abandoned epoch's batch
                continue
            self._pending[i] = (kind, payload)
        kind, payload = self._pending[self._next_out]
        if kind == "error":
            # the poison stays pending: a retried next() raises again
            if not self.loader.persistent_workers:
                self.pool.shutdown()
            raise RuntimeError(f"DataLoader worker failed: {payload}")
        del self._pending[self._next_out]
        self._next_out += 1
        if self._sent < self._n_batches:
            self.pool.submit((self._epoch, self._sent),
                             self._batches[self._sent])
            self._sent += 1
        if kind == "shm":
            blocks, spec = payload
            flat = []
            for name, shape, dtype in blocks:
                shm = shared_memory.SharedMemory(name=name)
                flat.append(np.ndarray(shape, np.dtype(dtype),
                                       buffer=shm.buf).copy())
                shm.close()
                shm.unlink()
        else:
            flat, spec = payload
        return _as_list(_to_tensor_tree(_unflatten_np(flat, spec)))


def prefetch_to_device(iterator, depth=2, device=None):
    """Yield ``iterator``'s batches with every Tensor (and torch tensor)
    on ``device`` (default: the card), staging up to ``depth`` batches
    ahead.  On the card each tensor goes through pinned host memory and a
    ``non_blocking`` copy on a side stream; the compute stream waits on
    an event recorded after the batch's copies, and the tensors are
    marked as used by it (``record_stream``), so the step that reads a
    batch never waits on the host.  On the CPU it is a plain ``to``."""
    from .. import resolve_device

    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def move(t):
        if dev.type != "cuda":
            return t.to(dev)
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def stage(batch, moved):
        if isinstance(batch, (list, tuple)):
            return [stage(b, moved) for b in batch]
        if isinstance(batch, dict):
            return {k: stage(v, moved) for k, v in batch.items()}
        if isinstance(batch, Tensor):
            v = move(batch._value)
            moved.append(v)
            return Tensor(v)
        if isinstance(batch, torch.Tensor):
            v = move(batch)
            moved.append(v)
            return v
        return batch

    def staged(batch):
        moved = []
        if side is None:
            return stage(batch, moved), None, moved
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = stage(batch, moved)
            event = torch.cuda.Event()
            event.record(side)
        return out, event, moved

    buf = []
    it = iter(iterator)
    try:
        for _ in range(depth):
            buf.append(staged(next(it)))
    except StopIteration:
        pass
    while buf:
        out, event, moved = buf.pop(0)
        if event is not None:
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(event)
            for v in moved:
                v.record_stream(compute)
        try:
            buf.append(staged(next(it)))
        except StopIteration:
            pass
        yield out


class _LoaderIter:
    """Feed path 3: thread workers."""

    def __init__(self, loader):
        self.loader = loader
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=max(2, loader.prefetch_factor))
        self._threads = []
        self._done = threading.Event()
        self._err = None
        n_workers = max(1, loader.num_workers)
        if isinstance(loader.dataset, IterableDataset):
            t = threading.Thread(target=self._iterable_worker, daemon=True)
            t.start()
            self._threads = [t]
            return
        self._index_queue: "queue.Queue" = queue.Queue()
        self._n_batches = 0
        for i, idxs in enumerate(loader.batch_sampler):
            self._index_queue.put((i, idxs))
            self._n_batches += 1
        self._results = {}
        self._cond = threading.Condition()
        self._next_out = 0
        for _ in range(n_workers):
            self._index_queue.put(_SENTINEL)
        for _ in range(n_workers):
            t = threading.Thread(target=self._map_worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _map_worker(self):
        ds = self.loader.dataset
        while not self._done.is_set():
            item = self._index_queue.get()
            if item is _SENTINEL:
                return
            i, idxs = item
            try:
                out = self.loader.collate_fn([ds[j] for j in idxs])
            except Exception as e:
                with self._cond:
                    self._err = e
                    self._cond.notify_all()
                self._done.set()
                return
            with self._cond:
                self._results[i] = out
                self._cond.notify_all()

    def _iterable_worker(self):
        try:
            batch = []
            for sample in self.loader.dataset:
                batch.append(sample)
                if len(batch) == self.loader.batch_size:
                    self._queue.put(self.loader.collate_fn(batch))
                    batch = []
            if batch and not self.loader.drop_last:
                self._queue.put(self.loader.collate_fn(batch))
        except Exception as e:
            self._err = e
        self._queue.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if isinstance(self.loader.dataset, IterableDataset):
            out = self._queue.get()
            if out is _SENTINEL:
                if self._err:
                    raise self._err
                raise StopIteration
            return _as_list(_to_tensor_tree(out))
        if self._next_out >= self._n_batches:
            raise StopIteration
        want = self._next_out
        with self._cond:
            self._cond.wait_for(lambda: want in self._results
                                or self._err is not None)
            if want not in self._results:
                raise self._err
            out = self._results.pop(want)
        self._next_out += 1
        return _as_list(_to_tensor_tree(out))

    def __del__(self):
        self._done.set()


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.drop_last = drop_last
        self.batch_size = batch_size
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._pool = None
        if isinstance(dataset, IterableDataset):
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __iter__(self):
        if (self.batch_sampler is not None
                and self.collate_fn is default_collate_fn):
            cols = _dataset_arrays(self.dataset)
            if cols is not None:
                return _ArrayIter(self, cols)
        if (self.num_workers > 0 and self.use_shared_memory
                and self.batch_sampler is not None):
            if self.persistent_workers:
                if self._pool is None or not self._pool.alive:
                    self._pool = _WorkerPool(self)
                return _ProcessIter(self, self._pool)
            return _ProcessIter(self, _WorkerPool(self))
        return _LoaderIter(self)

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("IterableDataset DataLoader has no len()")
