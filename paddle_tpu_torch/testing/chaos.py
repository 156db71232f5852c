"""Deterministic chaos injection — the plan machinery of
``paddle_tpu/testing/chaos.py`` that the ported serving stack and the
hapi train loop call.

A :class:`ChaosPlan` is a SCHEDULE of faults, not a probability: each
:class:`Fault` names an instrumented *site* and the evaluation index at
which it trips, so the same plan against the same workload produces the
same fault sequence.

Instrumented sites in this package
----------------------------------
``kv.allocate``       PagedKVCache.allocate — action ``deny`` simulates
                      transient page exhaustion (the scheduler preempts
                      or defers admission).  Key: seq_id.
``engine.step``       ServingEngine.step — ``raise`` injects an
                      engine-step exception, ``delay`` artificial step
                      latency.  Key: the engine's chaos key.
``serving.logits``    ServingEngine step, once per active lane before the
                      dispatch (key: the lane's request id) —
                      ``nan_logits`` poisons the lane's last written KV
                      page with NaN on the device (under int8 KV: that
                      page's K scale row), so the next dispatch's logits
                      for exactly that lane are non-finite and the
                      numeric guard quarantines the request.
``spec.draft``        ServingEngine._spec_step, before the drafter is
                      consulted — ``deny`` makes that step degrade to
                      plain decode (no drafts verified, nothing
                      reserved; the request stream is unchanged).
                      Evaluated once per spec-capable engine step.
                      Key: the engine's chaos key.
``serving.shard_sync``  ServingEngine, before each ragged dispatch of a
                      mesh engine (never on a single-device engine) —
                      ``delay`` models a straggler shard holding up the
                      step's tp/sp collectives (the whole replica
                      stalls: one mesh replica is one failure domain),
                      ``raise`` a failed cross-shard exchange, which
                      fails the step as a replica crash.  Key: the
                      engine's chaos key.
``replica.kill``      frontend pump loop, after each step — ``kill``
                      crashes the replica mid-decode (the generalized
                      form of ``Router.inject_failure``).  Key: replica
                      id.
``kv.ship``           frontend ``_ship_ready``, the prefill→decode page
                      hand-off — ``deny`` skips the ship, so the request
                      decodes in place on the prefill replica (the
                      stream is unchanged).  Key: request id.
``http.request``      ``POST /generate`` intake — ``http_error`` answers
                      with the fault's ``status`` before touching the
                      frontend.  Key: request path.
``train.step``        hapi ``fit``, before each train step — ``raise``
                      a transient step failure (retried), ``delay`` a
                      straggler step, ``kill`` a process death
                      (``FatalError``, never retried); the numeric
                      actions ``nan_loss`` (the step sees a copy of the
                      batch filled with NaN: the loss is non-finite),
                      ``nan_grad`` (a copy filled with the dtype's
                      largest finite value: the gradient norm
                      overflows) and ``corrupt_param`` (one element of
                      the parameter ``Fault(leaf=...)`` names, chosen
                      by :meth:`Fault.element_index`, set to NaN in
                      place on the device — the silent data corruption
                      the anomaly audit exists to catch).  Key: none.
``loader.next``       hapi ``fit``, before each batch fetch —
                      ``raise`` / ``delay`` a flaky or slow loader.
``ckpt.write``        ``framework_io.atomic_write_bytes``, the commit
                      path under every checkpoint (the CheckpointStore,
                      persisted serving snapshots) — ``raise`` at key
                      ``temp`` kills the writer with a PARTIAL temp file
                      on disk, at key ``rename`` after the durable temp
                      but before the rename.  Neither may ever corrupt a
                      committed slot.  Key: the injection point
                      (``temp`` | ``rename``).

Sites check ``chaos_site(site, key)``, which is a single global read when
no plan is installed — production paths pay nothing.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional

from ..framework.concurrency import OrderedLock

__all__ = ["Fault", "ChaosPlan", "install", "uninstall", "running",
           "chaos_site", "DENY", "RAISE", "DELAY", "KILL", "HTTP_ERROR",
           "NAN_LOSS", "NAN_GRAD", "CORRUPT_PARAM", "NAN_LOGITS"]

DENY = "deny"
RAISE = "raise"
DELAY = "delay"
KILL = "kill"
HTTP_ERROR = "http_error"
# numeric faults, returned to the caller like deny / kill: the train step
# poisons its batch (nan_loss, nan_grad) or a named parameter
# (corrupt_param), the serving engine a lane's KV page (nan_logits)
NAN_LOSS = "nan_loss"
NAN_GRAD = "nan_grad"
CORRUPT_PARAM = "corrupt_param"
NAN_LOGITS = "nan_logits"
_ACTIONS = frozenset({DENY, RAISE, DELAY, KILL, HTTP_ERROR, NAN_LOSS,
                      NAN_GRAD, CORRUPT_PARAM, NAN_LOGITS})


class Fault:
    """One scheduled fault: trips on the ``at``-th MATCHING evaluation
    of ``site`` (1-based), ``count`` times in a row.  At most one fault
    fires per site visit — the first armed match in plan order wins —
    and a visit claimed by an earlier fault does not advance a later
    fault's clock."""

    __slots__ = ("site", "at", "action", "match", "count", "delay_s",
                 "status", "message", "leaf", "seen", "remaining")

    def __init__(self, site: str, at: int, action: str,
                 match: Optional[str] = None, count: int = 1,
                 delay_s: float = 0.0, status: int = 500,
                 message: str = "", leaf: str = ""):
        if action not in _ACTIONS:
            raise ValueError(f"unknown chaos action {action!r}; one of "
                             f"{sorted(_ACTIONS)}")
        if at < 1:
            raise ValueError("at is a 1-based evaluation index (>= 1)")
        if action == CORRUPT_PARAM and not leaf:
            raise ValueError(
                "corrupt_param needs leaf= (the parameter whose element "
                "is set non-finite)")
        self.site = str(site)
        self.at = int(at)
        self.action = action
        self.match = match
        self.count = int(count)
        self.delay_s = float(delay_s)
        self.status = int(status)         # HTTP_ERROR's answer
        self.message = message or f"chaos[{site}@{at}:{action}]"
        self.leaf = str(leaf)
        self.seen = 0              # matching evaluations so far
        self.remaining = self.count

    def element_index(self, size: int) -> int:
        """The flat element ``corrupt_param`` flips: CRC32 of
        ``"{leaf}:{at}"`` modulo ``size`` — the JAX package's choice, so
        both packages poison the same element."""
        import zlib

        return zlib.crc32(f"{self.leaf}:{self.at}".encode()) % max(size, 1)

    def exception(self):
        from ..framework.errors import InternalError

        return InternalError(self.message)


class ChaosPlan:
    """An ordered set of faults plus the record of what actually fired.
    Thread-safe: per-fault counters advance under one lock."""

    def __init__(self, faults=(), name: str = "chaos-plan"):
        self._lock = OrderedLock("chaos.plan")
        self.faults: List[Fault] = list(faults)
        self.name = name
        # append-only log of fired faults: {site, key, action, seen}
        self.fired: List[dict] = []

    def fire(self, site: str, key: Optional[str] = None) -> Optional[Fault]:
        """Evaluate one site visit; returns the fault that trips or None."""
        with self._lock:
            for f in self.faults:
                if f.site != site:
                    continue
                if f.match is not None and f.match != key:
                    continue
                f.seen += 1
                if f.remaining > 0 and f.seen >= f.at:
                    f.remaining -= 1
                    self.fired.append({"site": site, "key": key,
                                       "action": f.action, "seen": f.seen})
                    return f
        return None

    def fired_log(self) -> List[dict]:
        """A copy of the record of fired faults, oldest first."""
        with self._lock:
            return list(self.fired)


_ACTIVE: Optional[ChaosPlan] = None
_INSTALL_LOCK = OrderedLock("chaos.install")


def install(plan: Optional[ChaosPlan]):
    """Install ``plan`` as the process-wide active plan (None clears)."""
    global _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = plan


def uninstall():
    install(None)


@contextlib.contextmanager
def running(plan: ChaosPlan):
    """``with chaos.running(plan): ...`` — install for the block, always
    uninstall after (even on failure)."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def chaos_site(site: str, key: Optional[str] = None) -> Optional[Fault]:
    """The instrumentation hook: one global read when no plan is active.

    ``delay`` sleeps and ``raise`` raises here; site-specific actions
    (``deny``, ``nan_logits``) are returned for the caller to act on.
    Every firing also lands in the flight recorder's fault ring."""
    plan = _ACTIVE
    if plan is None:
        return None
    fault = plan.fire(site, key)
    if fault is None:
        return None
    from ..profiler.flight_recorder import recorder

    recorder.on_fault(site, key, fault.action, fault.seen)
    if fault.action == DELAY:
        time.sleep(fault.delay_s)
        return fault
    if fault.action == RAISE:
        raise fault.exception()
    return fault
