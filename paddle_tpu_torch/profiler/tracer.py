"""Hierarchical span tracer — ``paddle_tpu/profiler/tracer.py``'s twin
(the reference framework's RecordEvent event tree: per-thread
PushEvent / PopEvent).

Thread-local span STACKS give every span a parent link and a depth;
completed spans are kept (bounded by ``MAX_SPANS``) only while tracing
is enabled, so with tracing off a span costs one lock-protected
aggregate update — cheap enough to stay on in a serving loop.  The
aggregate table (name -> calls / total / min / max) is always kept and
is what ``utils.profiler.summary()`` prints.  Host code only: a span
never touches a device.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "tracer", "enable_tracing", "disable_tracing",
           "tracing_enabled", "span", "instant", "get_spans",
           "clear_spans", "aggregates", "reset_aggregates"]

# span retention cap: at ~120 bytes/span this bounds tracer memory to
# ~100 MB even if a serving loop is left tracing for hours
MAX_SPANS = 1_000_000

_ids = itertools.count(1)  # itertools.count.__next__ is atomic in CPython


class Span:
    """One completed (or open) region: [start_ns, end_ns] on one thread."""

    __slots__ = ("name", "span_id", "parent_id", "depth", "tid",
                 "start_ns", "end_ns", "args")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 depth: int, tid: int, start_ns: int,
                 args: Optional[dict] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.depth = depth
        self.tid = tid
        self.start_ns = start_ns
        self.end_ns = 0
        self.args = args

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, depth={self.depth}, "
                f"dur={self.duration_ns / 1e6:.3f}ms)")


class _Agg:
    __slots__ = ("calls", "total_s", "min_s", "max_s")

    def __init__(self):
        self.calls = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0

    def add(self, dt: float):
        self.calls += 1
        self.total_s += dt
        if dt < self.min_s:
            self.min_s = dt
        if dt > self.max_s:
            self.max_s = dt


class Tracer:
    """Process-wide tracer: thread-local open-span stacks, a shared
    completed-span buffer (when enabled), and an always-on aggregate
    table."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self._tls = threading.local()
        self._lock = threading.Lock()      # guards _spans + _agg
        self._spans: List[Span] = []
        self._agg: Dict[str, _Agg] = {}
        self._instants: List[Span] = []
        self._enabled = False
        self._dropped = 0
        self._max_spans = max_spans

    # --- enable / disable --------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, clear: bool = True):
        """Start retaining spans.  ``clear`` drops previously captured
        spans (open stacks from before enable() parent to None)."""
        if clear:
            self.clear()
        self._enabled = True

    def disable(self):
        self._enabled = False

    def clear(self):
        with self._lock:
            self._spans = []
            self._instants = []
            self._dropped = 0

    # --- span lifecycle ----------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def begin(self, name: str, args: Optional[dict] = None) -> Span:
        stack = self._stack()
        parent = stack[-1] if stack else None
        sp = Span(name, next(_ids),
                  parent.span_id if parent is not None else None,
                  len(stack), threading.get_ident(),
                  time.perf_counter_ns(), args)
        stack.append(sp)
        return sp

    def end(self, sp: Span):
        sp.end_ns = time.perf_counter_ns()
        stack = self._stack()
        # tolerate out-of-order exits (generators suspended mid-span):
        # pop sp wherever it sits rather than corrupting the stack
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:
            stack.remove(sp)
        dt = sp.duration_ns / 1e9
        with self._lock:
            agg = self._agg.get(sp.name)
            if agg is None:
                agg = self._agg[sp.name] = _Agg()
            agg.add(dt)
            if self._enabled:
                if len(self._spans) < self._max_spans:
                    self._spans.append(sp)
                else:
                    self._dropped += 1

    def instant(self, name: str, args: Optional[dict] = None):
        """A zero-duration marker (step boundaries, admissions...)."""
        if not self._enabled:
            return
        sp = Span(name, next(_ids), None, 0, threading.get_ident(),
                  time.perf_counter_ns(), args)
        sp.end_ns = sp.start_ns
        with self._lock:
            if len(self._instants) < self._max_spans:
                self._instants.append(sp)
            else:
                # overflow is a fact the trace consumer must see —
                # instants share the ``dropped`` counter with spans
                # (previously they vanished uncounted past the cap)
                self._dropped += 1

    def span(self, name: str, **args):
        """Context-manager span: ``with tracer.span("serving.step"): ...``"""
        return _SpanContext(self, name, args or None)

    # --- inspection --------------------------------------------------------
    def get_spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def get_instants(self) -> List[Span]:
        with self._lock:
            return list(self._instants)

    @property
    def dropped(self) -> int:
        return self._dropped

    def aggregates(self) -> Dict[str, dict]:
        """name -> {calls, total_s, min_s, max_s, avg_s} snapshot."""
        with self._lock:
            return {
                name: {"calls": a.calls, "total_s": a.total_s,
                       "min_s": a.min_s if a.calls else 0.0,
                       "max_s": a.max_s,
                       "avg_s": a.total_s / a.calls if a.calls else 0.0}
                for name, a in self._agg.items()}

    def reset_aggregates(self):
        with self._lock:
            self._agg = {}


class _SpanContext:
    __slots__ = ("_tracer", "_name", "_args", "_span")

    def __init__(self, tracer_: Tracer, name: str, args: Optional[dict]):
        self._tracer = tracer_
        self._name = name
        self._args = args

    def __enter__(self) -> Span:
        self._span = self._tracer.begin(self._name, self._args)
        return self._span

    def __exit__(self, *exc):
        self._tracer.end(self._span)
        return False


# --- module-level singleton + convenience wrappers -------------------------
tracer = Tracer()


def enable_tracing(clear: bool = True):
    tracer.enable(clear=clear)


def disable_tracing():
    tracer.disable()


def tracing_enabled() -> bool:
    return tracer.enabled


def span(name: str, **args):
    return tracer.span(name, **args)


def instant(name: str, **args):
    tracer.instant(name, args or None)


def get_spans() -> List[Span]:
    return tracer.get_spans()


def clear_spans():
    tracer.clear()


def aggregates() -> Dict[str, dict]:
    return tracer.aggregates()


def reset_aggregates():
    tracer.reset_aggregates()
