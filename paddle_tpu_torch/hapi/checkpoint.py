"""Train state and crash-consistent, optionally async training
checkpoints — twin of ``paddle_tpu/hapi/checkpoint.py``.

One capture covers everything an exact resume needs:

- the network's weights and buffers and the optimizer's ``state_dict`` (its
  accumulators, ``step_count`` and the LR scheduler), read to the host;
- the port's device generators (``framework.random``), numpy's global
  stream (the samplers' shuffles) and ``py_random``;
- the data loader's position: (epoch, next batch) and numpy's and
  ``py_random``'s state AT EPOCH START, so a resumed run re-draws the
  same epoch permutation, skips the batches already trained and rejoins
  the streams where the capture left them;
- the global step counter.

The port keeps no functional state tree: the parameters stay in the
network and are updated in place, so there is one layout (the JAX
package's "eager" one).  A restore copies into the live parameters,
buffers and accumulators in place, so a captured train step keeps its
addresses.

:class:`TrainCheckpointer` drives an :class:`~paddle_tpu_torch.io.
checkpoint.CheckpointStore` with a double-buffered background writer:
the train loop blocks only for the device-to-host copy; serialization,
checksums and fsync run on the writer thread.  Metric names as the JAX
package's: ``train.checkpoint_ms``, ``train.checkpoint_write_ms``,
``train.checkpoint_bytes``, ``train.snapshots``, ``train.resumes``,
``train.recomputed_steps``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..framework.concurrency import OrderedCondition
from ..framework.errors import (CheckpointIncompatibleError,
                                ExecutionTimeoutError)
from ..framework.monitor import gauge_set, histogram_observe, stat_add
from ..framework.random import get_rng_state, py_random, set_rng_state
from ..io.checkpoint import CheckpointStore

__all__ = ["TRAIN_STATE_SCHEMA", "capture_train_state",
           "restore_train_state", "TrainCheckpointer"]

TRAIN_STATE_SCHEMA = 1


def _to_host(v):
    """A state entry as the host keeps it: tensors as numpy arrays (their
    own dtype, so the round trip is bitwise), dicts recursively, the
    rest as it is."""
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    if hasattr(v, "_value"):
        v = v._value
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().copy()
    return v


def network_state(network) -> Dict[str, torch.Tensor]:
    """``{name: torch tensor}`` of a port ``nn.Layer`` (its parameters
    and persistable buffers, restored in place like them) or a
    ``torch.nn.Module`` (its ``state_dict``)."""
    if isinstance(network, torch.nn.Module):
        return dict(network.state_dict(keep_vars=True))
    return {k: v._value for k, v in network.state_dict().items()}


def capture_train_state(model, *, global_step: int, epoch: int = 0,
                        next_batch: int = 0,
                        np_state_epoch_start=None,
                        py_state_epoch_start=None, np_random=None,
                        py_random_state=None) -> Dict[str, Any]:
    """Snapshot everything a bit-exact resume of ``model`` needs, as a
    host tree (CheckpointStore-serializable).  Call at a step boundary:
    after ``train_batch`` for batch ``next_batch - 1`` returned (its loss
    was read, so the step finished).  ``np_random`` / ``py_random_state``
    are the streams' states before batch ``next_batch`` was fetched
    (default: now)."""
    from ..optimizer.lr import LRScheduler

    opt = model._optimizer
    return {
        "schema": TRAIN_STATE_SCHEMA,
        "global_step": int(global_step),
        "rng": get_rng_state(),
        "np_random": (np_random if np_random is not None
                      else np.random.get_state()),
        "py_random": (py_random_state if py_random_state is not None
                      else py_random.getstate()),
        "loader": {
            "epoch": int(epoch),
            "next_batch": int(next_batch),
            "np_state_epoch_start": (np_state_epoch_start
                                     if np_state_epoch_start is not None
                                     else np.random.get_state()),
            "py_state_epoch_start": (py_state_epoch_start
                                     if py_state_epoch_start is not None
                                     else py_random.getstate()),
        },
        "optimizer_host": {
            "step_count": int(getattr(opt, "_step_count", 0)),
            "lr_scheduler": (opt._lr.state_dict()
                             if opt is not None
                             and isinstance(opt._lr, LRScheduler)
                             else None),
        },
        "mode": "eager",
        "model": {
            "net": _to_host(network_state(model.network)),
            "opt": _to_host(opt.state_dict()) if opt is not None else {},
        },
    }


def restore_train_state(model, state: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`capture_train_state`: copy the captured leaves
    back into ``model``'s parameters and optimizer (in place), restore
    the generators, and return the loader position ``{"epoch",
    "next_batch", "np_state_epoch_start", "np_random", ...,
    "global_step"}`` for the fit loop."""
    from ..optimizer.lr import LRScheduler

    schema = int(state.get("schema", -1))
    if schema > TRAIN_STATE_SCHEMA:
        raise CheckpointIncompatibleError(
            f"train-state schema {schema} is newer than this build's "
            f"{TRAIN_STATE_SCHEMA}")
    if state.get("mode") != "eager":
        raise CheckpointIncompatibleError(
            f"train-state mode {state.get('mode')!r}: the port restores "
            "the layer + optimizer layout ('eager') only")
    opt = model._optimizer
    live = network_state(model.network)
    with torch.no_grad():
        for k, v in state["model"]["net"].items():
            t = live[k]
            t.copy_(torch.as_tensor(np.asarray(v)).to(t.device, t.dtype))
    if opt is not None and state["model"]["opt"]:
        opt.set_state_dict(state["model"]["opt"])
    host = state.get("optimizer_host", {})
    if opt is not None:
        opt._step_count = int(host.get("step_count", opt._step_count))
        if (host.get("lr_scheduler") is not None
                and isinstance(opt._lr, LRScheduler)):
            opt._lr.set_state_dict(host["lr_scheduler"])
    set_rng_state(state["rng"])
    loader = dict(state["loader"])
    loader["np_random"] = state["np_random"]
    loader["py_random"] = state.get("py_random")
    loader.setdefault("py_state_epoch_start", None)
    loader["global_step"] = int(state["global_step"])
    return loader


class TrainCheckpointer:
    """Periodic, atomic, optionally-async training checkpoints over a
    :class:`CheckpointStore`.

    Threading: ONE background writer thread; the train loop and the
    writer hand off through a single ``train.snapshot``
    OrderedCondition (lock-order-witness clean: the writer serializes
    and commits OUTSIDE the lock, holding it only to take/clear the
    one-deep queue slot).  Write failures are remembered and re-raised
    on the NEXT submit/flush — a background disk error must not be
    silent, but also must not crash the step that happened to overlap
    it.
    """

    def __init__(self, store, interval: int = 1, async_write: bool = True,
                 keep_last: int = 3, progress_marker: bool = True):
        self.store = (store if isinstance(store, CheckpointStore)
                      else CheckpointStore(store, keep_last=keep_last))
        self.interval = max(1, int(interval))
        self.async_write = bool(async_write)
        self.progress_marker = bool(progress_marker)
        self._cond = OrderedCondition("train.snapshot")
        self._pending = None            # (state, step) | None — depth-1 queue
        self._writing = False
        self._closed = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        if self.async_write:
            self._thread = threading.Thread(
                target=self._run, name="train-snapshot-writer", daemon=True)
            self._thread.start()

    # --- progress marker ----------------------------------------------------
    @property
    def _progress_path(self) -> str:
        return os.path.join(self.store.directory, "PROGRESS")

    def note_step(self, global_step: int):
        """Record that ``global_step`` completed (tiny atomic write,
        chaos-exempt).  On resume, ``progress − checkpoint_step`` is the
        work the crash destroyed — surfaced as
        ``train.recomputed_steps``."""
        if not self.progress_marker:
            return
        from ..framework_io import atomic_write_bytes

        atomic_write_bytes(self._progress_path,
                           str(int(global_step)).encode(),
                           fsync=False, chaos=False)

    def progress_step(self) -> Optional[int]:
        try:
            with open(self._progress_path, "rb") as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    # --- snapshot path ------------------------------------------------------
    def due(self, global_step: int) -> bool:
        return global_step % self.interval == 0

    def snapshot(self, model, *, global_step: int, epoch: int,
                 next_batch: int, np_state_epoch_start,
                 py_state_epoch_start=None, np_random=None,
                 py_random=None) -> None:
        """Capture + hand off one checkpoint.  Blocks for the host copy
        (and, if BOTH writer buffers are busy, for the older write) —
        that blocking cost is the ``train.checkpoint_ms`` histogram."""
        t0 = time.perf_counter()
        state = capture_train_state(
            model, global_step=global_step, epoch=epoch,
            next_batch=next_batch,
            np_state_epoch_start=np_state_epoch_start,
            py_state_epoch_start=py_state_epoch_start, np_random=np_random,
            py_random_state=py_random)
        if self.async_write:
            with self._cond:
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                # double buffer: one write in flight + one queued
                self._cond.wait_for(lambda: self._pending is None)
                self._pending = (state, int(global_step))
                self._cond.notify_all()
        else:
            self._write(state, int(global_step))
        histogram_observe("train.checkpoint_ms",
                          (time.perf_counter() - t0) * 1e3)

    def maybe_snapshot(self, model, *, global_step: int, epoch: int,
                       next_batch: int, np_state_epoch_start,
                       py_state_epoch_start=None) -> bool:
        if not self.due(global_step):
            return False
        self.snapshot(model, global_step=global_step, epoch=epoch,
                      next_batch=next_batch,
                      np_state_epoch_start=np_state_epoch_start,
                      py_state_epoch_start=py_state_epoch_start)
        return True

    def _write(self, state, step: int):
        from ..profiler.flight_recorder import recorder as _flight

        t0 = time.perf_counter()
        path = self.store.save(state, step,
                               metadata={"kind": "train_state"})
        stat_add("train.snapshots", 1)
        gauge_set("train.checkpoint_bytes", os.path.getsize(path))
        histogram_observe("train.checkpoint_write_ms",
                          (time.perf_counter() - t0) * 1e3)
        _flight.on_transition("train.checkpoint", f"step-{step}", path)

    def _run(self):
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._pending is not None or self._closed)
                if self._pending is None:
                    return              # closed and drained
                state, step = self._pending
                self._pending = None
                self._writing = True
                self._cond.notify_all()
            try:
                self._write(state, step)
            except BaseException as e:  # noqa: BLE001 — surfaced later
                with self._cond:
                    self._error = e
            finally:
                with self._cond:
                    self._writing = False
                    self._cond.notify_all()

    # --- resume -------------------------------------------------------------
    def load_latest_state(self, verify: bool = True):
        """(state, manifest) of the newest VALID checkpoint, or None
        (corrupt entries are skipped by the store — crash recovery).
        ``verify=True`` (the default) applies the deep
        per-leaf CRC check: a checkpoint whose leaves drifted from
        their manifest records — disk-level silent data corruption —
        is skipped like a torn write instead of restored."""
        return self.store.load_latest(verify=verify)

    def resume(self, model) -> Optional[Dict[str, Any]]:
        """Restore the newest valid checkpoint into ``model``.  Returns
        the loader position (see :func:`restore_train_state`) or None
        when the store holds nothing usable.  Accounts
        ``train.resumes`` and ``train.recomputed_steps`` (progress
        marker minus checkpoint step — the steps the crash lost).
        Each checkpoint skipped as corrupt along the way counts into
        ``train.anomaly.corrupt_checkpoints`` and lands in the flight
        recorder."""
        from ..profiler.flight_recorder import recorder as _flight

        loaded = self.load_latest_state(verify=True)
        if self.store.last_skipped:
            stat_add("train.anomaly.corrupt_checkpoints",
                     len(self.store.last_skipped))
            for path, reason in self.store.last_skipped:
                _flight.on_transition("train.ckpt_corrupt", path,
                                      reason)
        if loaded is None:
            return None
        state, _manifest = loaded
        pos = restore_train_state(model, state)
        stat_add("train.resumes", 1)
        prog = self.progress_step()
        if prog is not None:
            stat_add("train.recomputed_steps",
                     max(0, prog - pos["global_step"]))
        _flight.on_transition(
            "train.resume", f"step-{pos['global_step']}",
            f"recomputed={max(0, (prog or 0) - pos['global_step'])}")
        return pos

    # --- lifecycle ----------------------------------------------------------
    def flush(self, timeout: Optional[float] = 60.0):
        """Block until no snapshot is queued or being written; re-raise
        a background write failure if one happened.  A TIMEOUT raises
        ExecutionTimeoutError (returning normally
        with a write still in flight reported durability the disk never
        delivered — callers treating flush() as a durability barrier
        must hear about it)."""
        if self.async_write:
            with self._cond:
                drained = self._cond.wait_for(
                    lambda: self._pending is None and not self._writing,
                    timeout)
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                if not drained:
                    raise ExecutionTimeoutError(
                        f"checkpoint writer still busy after {timeout}s "
                        "— flush() did not reach a durable state (the "
                        "queued/in-flight snapshot is NOT committed)")

    def close(self, timeout: Optional[float] = 60.0):
        if self._thread is None:
            return
        self.flush(timeout)
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)
        self._thread = None
