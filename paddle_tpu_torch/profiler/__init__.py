"""paddle_tpu_torch.profiler — the twin of ``paddle_tpu/profiler``: the
span tracer and its Chrome-trace export, request-scoped observability
(the flight recorder), the fleet SLO engine, the Prometheus text
exposition of the process-wide stat registry and the CUDA-graph runner
with its compile ledger (``jit_cost``).

Quick start::

    from paddle_tpu_torch import profiler

    profiler.enable_tracing()
    with profiler.span("train.step", step=0):
        ...
    profiler.export_chrome_trace("trace.json")        # chrome://tracing
    print(profiler.prometheus_text())                 # scrape format
"""
from __future__ import annotations

from ..framework.monitor import (gauge_set, histogram_observe,  # noqa: F401
                                 histogram_snapshot, stat_add, stat_get,
                                 stat_registry)
from .chrome_trace import (export_chrome_trace,  # noqa: F401
                           export_request_trace, request_trace_events,
                           to_trace_events)
from .exposition import (MetricsServer, prometheus_text,  # noqa: F401
                         start_metrics_server)
from .flight_recorder import (FlightRecorder, RequestTrace,  # noqa: F401
                              TraceContext, recorder)
from .jit_cost import (CompileBudget, CompileBudgetExceeded,  # noqa: F401
                       CompileLedger, JitCostRegistry, ProfiledGraph,
                       compile_budget, compile_ledger, cost_registry,
                       device_memory_stats, profiled_graph)
from .slo import (AlertCenter, SLOObjective, SLOPolicy,  # noqa: F401
                  SLOTracker, snap_to_bucket_bound)
from .tracer import (Span, Tracer, aggregates, clear_spans,  # noqa: F401
                     disable_tracing, enable_tracing, get_spans, instant,
                     reset_aggregates, span, tracer, tracing_enabled)

__all__ = [
    "Span", "Tracer", "tracer", "span", "instant",
    "enable_tracing", "disable_tracing", "tracing_enabled",
    "get_spans", "clear_spans", "aggregates", "reset_aggregates",
    "export_chrome_trace", "to_trace_events",
    "request_trace_events", "export_request_trace",
    "FlightRecorder", "RequestTrace", "TraceContext", "recorder",
    "SLOObjective", "SLOPolicy", "SLOTracker", "AlertCenter",
    "snap_to_bucket_bound",
    "prometheus_text", "start_metrics_server", "MetricsServer",
    "profiled_graph", "ProfiledGraph", "JitCostRegistry", "cost_registry",
    "device_memory_stats",
    "compile_ledger", "compile_budget", "CompileLedger",
    "CompileBudget", "CompileBudgetExceeded",
    "stat_add", "stat_get", "stat_registry",
    "histogram_observe", "histogram_snapshot", "gauge_set",
    "metrics_snapshot",
]


def metrics_snapshot() -> dict:
    """One-call observability dump: counters, labeled gauges, histogram
    percentiles, recent-window histograms, span aggregates, per-program
    graph costs and the cards' memory stats — what a postmortem bundle
    carries under ``metrics``."""
    return {
        "stats": stat_registry.stat_values(),
        "gauges": {
            name: {",".join(f"{k}={v}" for k, v in key) or "_": val
                   for key, val in g.values().items()}
            for name, g in stat_registry.labeled_gauges().items()},
        "histograms": stat_registry.histogram_snapshots(),
        "windowed": stat_registry.windowed_snapshots(),
        "span_aggregates": aggregates(),
        "jit_costs": cost_registry.snapshot(),
        "device_memory": device_memory_stats(),
    }
