"""Chrome trace-event JSON export of the host spans —
``paddle_tpu/profiler/chrome_trace.py``'s twin.

Emits the Trace Event Format's JSON-object form: complete events
(``ph: "X"``, microsecond ts / dur) for spans, instant events
(``ph: "i"``) for markers, and metadata events naming the process and
threads.  The file loads in chrome://tracing and in Perfetto; a span's
children sit inside it on the same row.  The device timeline comes from
``torch.profiler`` (``utils.profiler.stop_profiler(timeline_path=)``).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

from .tracer import Span, tracer

__all__ = ["to_trace_events", "export_chrome_trace",
           "request_trace_events", "export_request_trace"]


def to_trace_events(spans: Optional[List[Span]] = None,
                    instants: Optional[List[Span]] = None,
                    process_name: str = "paddle_tpu_torch") -> dict:
    """Build the {"traceEvents": [...]} dict from (default: the global
    tracer's) spans."""
    if spans is None:
        spans = tracer.get_spans()
    if instants is None:
        instants = tracer.get_instants()
    pid = os.getpid()
    events = [{
        "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    tids = sorted({sp.tid for sp in spans} | {sp.tid for sp in instants})
    # chrome's UI sorts rows by tid; remap the (huge) python thread idents
    # to small stable indices so the timeline reads top-down
    tid_map = {t: i for i, t in enumerate(tids)}
    for t, i in tid_map.items():
        events.append({
            "ph": "M", "pid": pid, "tid": i, "name": "thread_name",
            "args": {"name": f"thread-{i} ({t})"},
        })
    for sp in spans:
        ev = {
            "ph": "X", "pid": pid, "tid": tid_map[sp.tid],
            "name": sp.name, "cat": "host",
            "ts": sp.start_ns / 1e3, "dur": sp.duration_ns / 1e3,
            "args": {"span_id": sp.span_id, "depth": sp.depth},
        }
        if sp.parent_id is not None:
            ev["args"]["parent_id"] = sp.parent_id
        if sp.args:
            ev["args"].update(sp.args)
        events.append(ev)
    for sp in instants:
        ev = {
            "ph": "i", "pid": pid, "tid": tid_map[sp.tid],
            "name": sp.name, "cat": "marker",
            "ts": sp.start_ns / 1e3, "s": "t",
        }
        if sp.args:
            ev["args"] = dict(sp.args)
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str,
                        spans: Optional[List[Span]] = None,
                        instants: Optional[List[Span]] = None) -> str:
    """Write the Chrome trace JSON to ``path``; returns the path."""
    doc = to_trace_events(spans, instants)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


# --- request-lifecycle timelines -------------------------------------------
def request_trace_events(trace: dict) -> dict:
    """Render ONE request's structured timeline (the dict
    ``flight_recorder.FlightRecorder.trace`` / ``frontend.trace(rid)``
    returns) as a Chrome trace document.

    Rows (tids): one per replica the request touched, plus a
    ``frontend`` row for placement/terminal events that happen off any
    replica.  Every lifecycle event is an instant (``ph: "i"``); per
    replica one complete event (``ph: "X"``) spans that replica's first
    to last event — a warm-failover trace therefore shows two bars on
    two rows inside ONE file, the donor's ending where the survivor's
    ``resumed_on`` begins."""
    pid = os.getpid()
    events = [{
        "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
        "args": {"name": f"request {trace.get('request_id', '?')} "
                         f"({trace.get('status') or 'live'})"},
    }]
    rows = ["frontend"] + list(trace.get("replicas", []))
    tid_of = {name: i for i, name in enumerate(rows)}
    for name, tid in tid_of.items():
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
    per_row_span: dict = {}
    for ev in trace.get("events", []):
        tid = tid_of.get(ev.get("replica") or "frontend", 0)
        ts_us = ev["ts_ns"] / 1e3
        args = {k: v for k, v in ev.items()
                if k not in ("ts_ns", "kind", "t_ms")}
        events.append({"ph": "i", "pid": pid, "tid": tid,
                       "name": ev["kind"], "cat": "lifecycle",
                       "ts": ts_us, "s": "t", "args": args})
        row = ev.get("replica") or "frontend"
        lo, hi = per_row_span.get(row, (ts_us, ts_us))
        per_row_span[row] = (min(lo, ts_us), max(hi, ts_us))
    for row, (lo, hi) in sorted(per_row_span.items()):
        events.append({
            "ph": "X", "pid": pid, "tid": tid_of[row],
            "name": f"{trace.get('request_id', '?')}@{row}",
            "cat": "request", "ts": lo, "dur": max(hi - lo, 1.0),
            "args": {"status": trace.get("status")}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_request_trace(path: str, trace: dict) -> str:
    """Write one request timeline (failover traces span both replicas
    in the single file) as Chrome trace JSON; returns the path."""
    doc = request_trace_events(trace)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
