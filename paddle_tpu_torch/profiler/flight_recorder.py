"""Always-on flight recorder + request-lifecycle traces — the ring part of
``paddle_tpu/profiler/flight_recorder.py``.

Every request the engine admits gets a typed event timeline (admission,
prefix hit, prefill chunks, first token, preemption/replay, terminal
outcome), and fixed-size rings always hold the last N lifecycle events,
engine step records, chaos fault firings and state transitions (prefix
evictions, brownout stage changes).  Appends are O(1) host work.

Left out of this slice: postmortem bundle export (``build_bundle`` /
``dump`` / ``auto_dump`` and dump-time context providers) — it reaches
the JAX package's compile ledger and checkpoint writer, which have no
port yet.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

from ..framework.concurrency import OrderedLock
from ..framework.monitor import stat_registry

__all__ = [
    "FlightRecorder", "RequestTrace", "recorder",
    "EV_ADMITTED", "EV_PREFIX_HIT", "EV_PREFILL_CHUNK", "EV_FIRST_TOKEN",
    "EV_SPECULATED", "EV_PREEMPTED", "EV_TERMINAL", "LIFECYCLE_EVENTS",
]

# the request lifecycle event taxonomy this slice records
EV_ADMITTED = "admitted"          # engine admitted it into the batch
EV_PREFIX_HIT = "prefix_hit"      # radix index covered {tokens} positions
EV_PREFILL_CHUNK = "prefill_chunk"  # one chunked-prefill dispatch {size}
EV_FIRST_TOKEN = "first_token"    # first decode token consumed
EV_SPECULATED = "speculated"      # one verify dispatch {drafted, accepted}
EV_PREEMPTED = "preempted"        # evicted mid-decode (replays later)
EV_TERMINAL = "terminal"          # exactly-once final outcome {status}
LIFECYCLE_EVENTS = frozenset({
    EV_ADMITTED, EV_PREFIX_HIT, EV_PREFILL_CHUNK, EV_FIRST_TOKEN,
    EV_SPECULATED, EV_PREEMPTED, EV_TERMINAL})


def _now_ns() -> int:
    return time.monotonic_ns()


class RequestTrace:
    """The typed event timeline of ONE request (host bookkeeping only)."""

    __slots__ = ("request_id", "events", "status", "created_ns")

    def __init__(self, request_id: str):
        self.request_id = request_id
        self.events: List[dict] = []
        self.status: Optional[str] = None
        self.created_ns = _now_ns()

    def timeline(self) -> dict:
        base = self.events[0]["ts_ns"] if self.events else self.created_ns
        return {
            "request_id": self.request_id,
            "status": self.status,
            "events": [dict(e, t_ms=round((e["ts_ns"] - base) / 1e6, 3))
                       for e in self.events],
        }


class FlightRecorder:
    """Bounded, always-on black box: four ``deque(maxlen=ring_size)``
    rings (lifecycle / engine steps / chaos faults / transitions), a
    ``traces_keep``-deep ring of terminal request timelines and a
    ``live_cap`` bound on in-flight traces (the oldest is evicted, never
    unbounded growth)."""

    def __init__(self, ring_size: int = 4096, traces_keep: int = 128,
                 live_cap: int = 4096):
        self._lock = OrderedLock("recorder.ring")
        self.enabled = True
        self._events: deque = deque(maxlen=int(ring_size))
        self._steps: deque = deque(maxlen=int(ring_size))
        self._faults: deque = deque(maxlen=int(ring_size))
        self._transitions: deque = deque(maxlen=int(ring_size))
        self._live: Dict[str, RequestTrace] = {}
        self._live_cap = int(live_cap)
        self._done: deque = deque(maxlen=int(traces_keep))
        self._done_by_id: Dict[str, RequestTrace] = {}

    def reset(self):
        with self._lock:
            self._events.clear()
            self._steps.clear()
            self._faults.clear()
            self._transitions.clear()
            self._live.clear()
            self._done.clear()
            self._done_by_id.clear()
        stat_registry.get("serving.trace.live").set(0)

    def _append(self, ring: deque, entry: dict):
        with self._lock:
            if len(ring) == ring.maxlen:
                stat_registry.get("recorder.dropped").add(1)
            ring.append(entry)
        stat_registry.get("recorder.events").add(1)

    def _retire_locked(self, tr: RequestTrace):
        if len(self._done) == self._done.maxlen:
            self._done_by_id.pop(self._done[0].request_id, None)
        self._done.append(tr)
        self._done_by_id[tr.request_id] = tr

    def request_event(self, request_id: str, kind: str, **attrs):
        """Record one lifecycle event for ``request_id`` (auto-creates
        the trace) and mirror it into the lifecycle ring."""
        if not self.enabled:
            return
        ev = {"ts_ns": _now_ns(), "kind": kind, "rid": request_id}
        ev.update(attrs)
        with self._lock:
            tr = self._live.get(request_id)
            if tr is None and request_id not in self._done_by_id:
                if len(self._live) >= self._live_cap:
                    old_rid = next(iter(self._live))
                    self._retire_locked(self._live.pop(old_rid))
                    stat_registry.get("serving.trace.evictions").add(1)
                tr = self._live[request_id] = RequestTrace(request_id)
            if tr is not None:
                tr.events.append(ev)
            if len(self._events) == self._events.maxlen:
                stat_registry.get("recorder.dropped").add(1)
            self._events.append(ev)
        stat_registry.get("serving.trace.events").add(1)
        stat_registry.get("recorder.events").add(1)

    def request_terminal(self, request_id: str, status: str, **attrs):
        """Exactly-once terminal event: the first wins; the trace moves
        to the bounded terminal ring."""
        if not self.enabled:
            return
        ev = {"ts_ns": _now_ns(), "kind": EV_TERMINAL,
              "rid": request_id, "status": status}
        ev.update(attrs)
        with self._lock:
            tr = self._live.pop(request_id, None)
            if tr is None:
                return                    # already terminal (or unknown)
            tr.status = status
            tr.events.append(ev)
            self._retire_locked(tr)
            self._events.append(ev)
            live_n = len(self._live)
        stat_registry.get("serving.trace.terminals").add(1)
        stat_registry.get("serving.trace.events").add(1)
        stat_registry.get("serving.trace.live").set(live_n)

    def on_step(self, replica: Optional[str], *, bucket: int, lanes: int,
                pages_in_use: int, step_ms: float):
        """One engine step record (bucket, dispatched lanes, pages in
        use, latency)."""
        if not self.enabled:
            return
        self._append(self._steps, {
            "ts_ns": _now_ns(), "replica": replica, "bucket": bucket,
            "lanes": lanes, "pages_in_use": pages_in_use,
            "step_ms": round(step_ms, 3)})

    def on_fault(self, site: str, key: Optional[str], action: str,
                 seen: int):
        """A chaos fault fired (testing.chaos reports every firing)."""
        if not self.enabled:
            return
        self._append(self._faults, {
            "ts_ns": _now_ns(), "site": site, "key": key,
            "action": action, "seen": seen})

    def on_transition(self, kind: str, target: str, detail: str = ""):
        """A state transition: a burst of prefix-index evictions, a
        brownout stage change."""
        if not self.enabled:
            return
        self._append(self._transitions, {
            "ts_ns": _now_ns(), "kind": kind, "target": target,
            "detail": detail})

    def transitions(self) -> List[dict]:
        """The transitions ring, oldest first."""
        with self._lock:
            return list(self._transitions)

    def trace(self, request_id: str) -> Optional[dict]:
        """Structured timeline of a live or recently-terminal request."""
        with self._lock:
            tr = self._live.get(request_id) \
                or self._done_by_id.get(request_id)
            return None if tr is None else tr.timeline()


# the process-wide always-on instance
recorder = FlightRecorder()
