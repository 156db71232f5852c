"""Always-on flight recorder + request-lifecycle traces — the twin of
``paddle_tpu/profiler/flight_recorder.py``.

- :class:`RequestTrace` / :class:`TraceContext` — every request the
  ServingFrontend admits gets a trace id (its request id) and a typed
  event timeline threaded through placement, engine admission, prefill
  chunks, first token, preemption/replay, snapshots, failover and the
  terminal outcome.  ``frontend.trace(rid)`` returns the structured
  timeline.
- :class:`FlightRecorder` — fixed-size ring buffers (O(1) append, pure
  host work: steady-state decode stays free of device syncs and of
  graph re-captures) that ALWAYS record the last N lifecycle events,
  engine step records, chaos fault firings and
  watchdog/brownout/replica transitions, fleet-wide.  On replica death
  or an explicit ``dump()`` the recorder writes a **postmortem bundle**
  (ring contents + ``profiler.metrics_snapshot()`` + compile-ledger
  events + registered context such as per-replica ``engine.stats()`` +
  the live traces of in-flight requests) through
  ``framework_io.atomic_write_bytes``.

One process-wide instance (``flight_recorder.recorder``) serves the
whole stack.  Locking: one ``OrderedLock`` guards the rings; no other
lock is ever taken while holding it and nothing blocking runs under it,
so the witness stays clean no matter which serving lock the caller
holds.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..framework.concurrency import OrderedLock
from ..framework.monitor import stat_registry

__all__ = [
    "FlightRecorder", "RequestTrace", "TraceContext", "recorder",
    "EV_QUEUED", "EV_PLACED", "EV_ADMITTED", "EV_PREFIX_HIT",
    "EV_PREFILL_CHUNK", "EV_FIRST_TOKEN", "EV_SPECULATED",
    "EV_PREEMPTED", "EV_SNAPSHOT", "EV_RESUMED_ON", "EV_RESTARTED",
    "EV_SHIPPED", "EV_TERMINAL", "LIFECYCLE_EVENTS", "BUNDLE_SCHEMA",
]

# --- the request lifecycle event taxonomy -----------------------------------
EV_QUEUED = "queued"              # submit accepted the request
EV_PLACED = "placed"              # router chose a replica {replica}
EV_ADMITTED = "admitted"          # engine admitted it into the batch
EV_PREFIX_HIT = "prefix_hit"      # radix index covered {tokens} positions
EV_PREFILL_CHUNK = "prefill_chunk"  # one chunked-prefill dispatch {size}
EV_FIRST_TOKEN = "first_token"    # first decode token consumed
EV_SPECULATED = "speculated"      # one verify dispatch {drafted, accepted}
EV_PREEMPTED = "preempted"        # evicted mid-decode (replays later)
EV_SNAPSHOT = "snapshot"          # warm-failover checkpoint {tokens}
EV_RESUMED_ON = "resumed_on"      # failover resume {replica, from}
EV_RESTARTED = "restarted"        # failover with no checkpoint (token 0)
EV_SHIPPED = "shipped"            # prefill→decode page ship {replica, pages}
EV_TERMINAL = "terminal"          # exactly-once final outcome {status}
LIFECYCLE_EVENTS = frozenset({
    EV_QUEUED, EV_PLACED, EV_ADMITTED, EV_PREFIX_HIT, EV_PREFILL_CHUNK,
    EV_FIRST_TOKEN, EV_SPECULATED, EV_PREEMPTED, EV_SNAPSHOT,
    EV_RESUMED_ON, EV_RESTARTED, EV_SHIPPED, EV_TERMINAL})

BUNDLE_SCHEMA = 1


def _now_ns() -> int:
    return time.monotonic_ns()


class RequestTrace:
    """The typed event timeline of ONE request (host bookkeeping only).

    Events are ``{"ts_ns", "kind", "replica"?, ...attrs}`` dicts in
    record order; ``status`` is set exactly once by the first
    ``terminal`` event.  Mutated only under the owning recorder's lock;
    ``timeline()`` returns an independent copy safe to serialize."""

    __slots__ = ("request_id", "events", "status", "created_ns")

    def __init__(self, request_id: str):
        self.request_id = request_id
        self.events: List[dict] = []
        self.status: Optional[str] = None
        self.created_ns = _now_ns()

    def timeline(self) -> dict:
        """JSON-ready structured timeline (ts both absolute-monotonic ns
        and ms relative to the first event — the exporter/HTTP view)."""
        base = self.events[0]["ts_ns"] if self.events else self.created_ns
        return {
            "request_id": self.request_id,
            "status": self.status,
            "replicas": sorted({e["replica"] for e in self.events
                                if e.get("replica")}),
            "events": [dict(e, t_ms=round((e["ts_ns"] - base) / 1e6, 3))
                       for e in self.events],
        }


class TraceContext:
    """A request's handle into the recorder: (trace id, recorder) — the
    lightweight object the frontend threads through its bookkeeping so
    recording a lifecycle event is one method call, pure host."""

    __slots__ = ("trace_id", "recorder")

    def __init__(self, trace_id: str, recorder_: "FlightRecorder"):
        self.trace_id = trace_id
        self.recorder = recorder_

    def event(self, kind: str, **attrs):
        self.recorder.request_event(self.trace_id, kind, **attrs)

    def terminal(self, status: str, **attrs):
        self.recorder.request_terminal(self.trace_id, status, **attrs)


class FlightRecorder:
    """Bounded, always-on black box for the serving/training stacks.

    Ring sizing: four ``deque(maxlen=ring_size)`` rings (lifecycle /
    engine steps / chaos faults / state transitions) plus a
    ``traces_keep``-deep ring of terminal request timelines and a
    ``live_cap`` bound on in-flight traces (an abandoned trace is
    evicted oldest-first, never grows without bound).  Appends are O(1)
    and allocation-light; ``enabled=False`` turns every hook into one
    attribute read (the bench's OFF arm).
    """

    GAUGES = ("serving.trace.live",)
    COUNTERS = ("serving.trace.events", "serving.trace.terminals",
                "serving.trace.evictions", "recorder.events",
                "recorder.dropped", "recorder.bundles")
    HISTOGRAMS = ("recorder.dump_ms",)

    def __init__(self, ring_size: int = 4096, traces_keep: int = 128,
                 live_cap: int = 4096,
                 bundle_dir: Optional[str] = None):
        self._lock = OrderedLock("recorder.ring")
        self.enabled = True
        self.bundle_dir = bundle_dir
        self._ring_size = int(ring_size)
        self._traces_keep = int(traces_keep)
        self._live_cap = int(live_cap)
        self._events: deque = deque(maxlen=self._ring_size)
        self._steps: deque = deque(maxlen=self._ring_size)
        self._faults: deque = deque(maxlen=self._ring_size)
        self._transitions: deque = deque(maxlen=self._ring_size)
        self._live: Dict[str, RequestTrace] = {}
        self._done: deque = deque(maxlen=self._traces_keep)
        self._done_by_id: Dict[str, RequestTrace] = {}
        # dump-time context providers (the frontend registers a callable
        # returning per-replica engine.stats(); training registers the
        # checkpointer's store state) — called OUTSIDE the ring lock
        self._context: Dict[str, Callable[[], dict]] = {}
        self._bundles = 0
        self._last_bundle_path: Optional[str] = None

    # --- configuration ------------------------------------------------------
    def configure(self, *, bundle_dir: Optional[str] = None,
                  enabled: Optional[bool] = None):
        """Adjust the always-on singleton without rebuilding it (tests,
        bench A/B arms, operators pointing bundles at a crash dir)."""
        if bundle_dir is not None:
            self.bundle_dir = bundle_dir
        if enabled is not None:
            self.enabled = bool(enabled)

    def reset(self):
        """Drop every ring, trace and context provider (test isolation;
        the determinism pin resets between double drives)."""
        with self._lock:
            self._events.clear()
            self._steps.clear()
            self._faults.clear()
            self._transitions.clear()
            self._live.clear()
            self._done.clear()
            self._done_by_id.clear()
            self._bundles = 0
            self._last_bundle_path = None
        self._context.clear()
        stat_registry.get("serving.trace.live").set(0)

    # --- ring appends (all O(1), never call out under the lock) -------------
    def _append(self, ring: deque, entry: dict):
        with self._lock:
            if len(ring) == ring.maxlen:
                stat_registry.get("recorder.dropped").add(1)
            ring.append(entry)
        stat_registry.get("recorder.events").add(1)

    def start_trace(self, request_id: str) -> TraceContext:
        """Begin a request trace (frontend.submit assigns the trace id);
        returns the TraceContext the frontend threads along — the caller
        records ``queued`` as its first event."""
        ctx = TraceContext(request_id, self)
        if self.enabled:
            with self._lock:
                if request_id not in self._live:
                    if len(self._live) >= self._live_cap:
                        # evict the oldest live trace — an abandoned
                        # stream must not pin memory forever
                        old_rid = next(iter(self._live))
                        self._retire_locked(self._live.pop(old_rid))
                        stat_registry.get(
                            "serving.trace.evictions").add(1)
                    self._live[request_id] = RequestTrace(request_id)
                live_n = len(self._live)
            stat_registry.get("serving.trace.live").set(live_n)
        return ctx

    def request_event(self, request_id: str, kind: str, **attrs):
        """Record one lifecycle event for ``request_id`` (auto-creates
        the trace so a standalone engine — no frontend — still builds
        timelines) and mirror it into the fleet-wide lifecycle ring."""
        if not self.enabled:
            return
        ev = {"ts_ns": _now_ns(), "kind": kind, "rid": request_id}
        if attrs:
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
        """Exactly-once terminal event: the first wins (the engine's
        completed-at-retire and the frontend's resolve race benignly),
        the trace moves to the bounded terminal ring."""
        if not self.enabled:
            return
        ev = {"ts_ns": _now_ns(), "kind": EV_TERMINAL,
              "rid": request_id, "status": status}
        if attrs:
            ev.update(attrs)
        with self._lock:
            tr = self._live.pop(request_id, None)
            if tr is None:
                return                    # already terminal (or unknown)
            tr.status = status
            tr.events.append(ev)
            self._retire_locked(tr)
            if len(self._events) == self._events.maxlen:
                stat_registry.get("recorder.dropped").add(1)
            self._events.append(ev)
            live_n = len(self._live)
        stat_registry.get("serving.trace.terminals").add(1)
        stat_registry.get("serving.trace.events").add(1)
        stat_registry.get("recorder.events").add(1)
        stat_registry.get("serving.trace.live").set(live_n)

    def _retire_locked(self, tr: RequestTrace):
        if len(self._done) == self._done.maxlen:
            old = self._done[0]
            self._done_by_id.pop(old.request_id, None)
        self._done.append(tr)
        self._done_by_id[tr.request_id] = tr

    def on_step(self, replica: Optional[str], *, bucket: int, lanes: int,
                pages_in_use: int, step_ms: float):
        """One engine step record (batch bucket, dispatched lanes, pages
        in use, latency) — the "what was the fleet doing" ring."""
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
        """A fleet state transition: watchdog verdicts, brownout stage
        changes, replica health changes, train-loop retries/fatals."""
        if not self.enabled:
            return
        self._append(self._transitions, {
            "ts_ns": _now_ns(), "kind": kind, "target": target,
            "detail": detail})

    # --- inspection ---------------------------------------------------------
    def transitions(self) -> List[dict]:
        """The transitions ring, oldest first."""
        with self._lock:
            return list(self._transitions)

    def trace(self, request_id: str) -> Optional[dict]:
        """Structured timeline of a live or recently-terminal request;
        None when unknown (or long since evicted)."""
        with self._lock:
            tr = self._live.get(request_id) \
                or self._done_by_id.get(request_id)
            if tr is None:
                return None
            return tr.timeline()

    def recent_traces(self) -> List[dict]:
        """Recent TERMINAL requests, newest last: {rid, status, events,
        duration} summaries (the ``GET /debug/requests`` listing)."""
        with self._lock:
            done = list(self._done)
        out = []
        for tr in done:
            first = tr.events[0]["ts_ns"] if tr.events else tr.created_ns
            last = tr.events[-1]["ts_ns"] if tr.events else tr.created_ns
            out.append({"request_id": tr.request_id, "status": tr.status,
                        "events": len(tr.events),
                        "duration_ms": round((last - first) / 1e6, 3)})
        return out

    def live_request_ids(self) -> List[str]:
        with self._lock:
            return list(self._live)

    def register_context(self, name: str, provider: Callable[[], dict]):
        """Register a dump-time context provider (e.g. the frontend's
        per-replica ``engine.stats()``); called OUTSIDE the ring lock at
        dump time, exceptions degrade to an error string in the bundle."""
        self._context[name] = provider

    def unregister_context(self, name: str):
        self._context.pop(name, None)

    def snapshot(self) -> dict:
        """Recorder health for stats() surfaces."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "ring_size": self._ring_size,
                "events": len(self._events),
                "steps": len(self._steps),
                "faults": len(self._faults),
                "transitions": len(self._transitions),
                "live_traces": len(self._live),
                "terminal_traces": len(self._done),
                "bundles": self._bundles,
                "last_bundle": self._last_bundle_path,
                "bundle_dir": self.bundle_dir,
            }

    # --- postmortem bundles -------------------------------------------------
    def build_bundle(self, reason: str) -> dict:
        """Assemble the postmortem bundle dict: ring contents, the full
        metrics snapshot, compile-ledger events, registered context
        (per-replica engine stats, ...) and the live traces of every
        in-flight request."""
        from . import metrics_snapshot
        from .jit_cost import compile_ledger

        with self._lock:
            events = [dict(e) for e in self._events]
            steps = [dict(e) for e in self._steps]
            faults = [dict(e) for e in self._faults]
            transitions = [dict(e) for e in self._transitions]
            live = [tr.timeline() for tr in self._live.values()]
            done = [tr.timeline() for tr in self._done]
        context = {}
        for name, provider in list(self._context.items()):
            try:
                context[name] = provider()
            except Exception as e:  # noqa: BLE001 — a dying engine's
                # stats() may raise; the bundle must still be written
                context[name] = {"error": f"{type(e).__name__}: {e}"}
        return {
            "schema": BUNDLE_SCHEMA,
            "reason": reason,
            "created_unix": time.time(),
            "pid": os.getpid(),
            "events": events,
            "engine_steps": steps,
            "chaos_faults": faults,
            "transitions": transitions,
            "live_traces": live,
            "terminal_traces": done,
            "metrics": metrics_snapshot(),
            "compile_ledger": [
                {"name": n, "signature": s, "fallback": f}
                for n, s, f in compile_ledger.events()],
            "context": context,
        }

    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> dict:
        """Write a postmortem bundle and return it.  ``path=None`` picks
        ``<bundle_dir>/postmortem-<n>.json`` (bundle_dir must be set);
        the write commits through ``atomic_write_bytes`` so a bundle is
        never torn — even a crash while dumping leaves the previous
        complete bundle."""
        from ..framework.errors import InvalidArgumentError
        from ..framework_io import atomic_write_bytes

        t0 = time.perf_counter()
        bundle = self.build_bundle(reason)
        if path is None:
            if self.bundle_dir is None:
                raise InvalidArgumentError(
                    "dump() needs a path or a configured bundle_dir")
            # RESERVE the index atomically: two replicas dying at once
            # dump from two pump threads, and a shared index would make
            # the second bundle overwrite the first — destroying
            # exactly the black box this feature exists to preserve
            with self._lock:
                n = self._bundles
                self._bundles += 1
            path = os.path.join(self.bundle_dir,
                                f"postmortem-{n:04d}.json")
        else:
            with self._lock:
                self._bundles += 1
        bundle["path"] = path
        data = json.dumps(bundle, default=str).encode()
        # chaos=False: a bundle dump happens INSIDE failure handling —
        # re-evaluating ckpt.write faults here would make the black box
        # itself crash under the very schedule it exists to explain
        atomic_write_bytes(path, data, fsync=True, chaos=False)
        with self._lock:
            self._last_bundle_path = path
        stat_registry.get("recorder.bundles").add(1)
        stat_registry.histogram("recorder.dump_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return bundle

    def auto_dump(self, reason: str) -> Optional[dict]:
        """Crash-path dump: writes a bundle only when ``bundle_dir`` is
        configured (a test fleet without one must not pay bundle
        assembly per injected kill); never raises — the failover that
        triggered it must proceed no matter what."""
        if not self.enabled or self.bundle_dir is None:
            return None
        try:
            return self.dump(reason)
        except Exception:  # noqa: BLE001 — the black box must never
            return None    # turn a survivable crash into a fatal one


# the process-wide always-on instance (the ``tracer`` of crash forensics)
recorder = FlightRecorder()
