"""paddle_tpu_torch.profiler — the twin of ``paddle_tpu/profiler``:
request-scoped observability (the flight recorder), the fleet SLO
engine, the Prometheus text exposition of the process-wide stat
registry and the CUDA-graph runner with its compile ledger
(``jit_cost``).  The span tracer and the Chrome-trace export are not
ported yet (ROADMAP queue 1 item 7)."""
from __future__ import annotations

from ..framework.monitor import (gauge_set, histogram_observe,  # noqa: F401
                                 histogram_snapshot, stat_add, stat_get,
                                 stat_registry)
from .exposition import (MetricsServer, prometheus_text,  # noqa: F401
                         start_metrics_server)
from .flight_recorder import (FlightRecorder, RequestTrace,  # noqa: F401
                              TraceContext, recorder)
from .jit_cost import (CompileBudget, CompileBudgetExceeded,  # noqa: F401
                       CompileLedger, JitCostRegistry, ProfiledGraph,
                       compile_budget, compile_ledger, cost_registry,
                       profiled_graph)
from .slo import (AlertCenter, SLOObjective, SLOPolicy,  # noqa: F401
                  SLOTracker, snap_to_bucket_bound)

__all__ = [
    "FlightRecorder", "RequestTrace", "TraceContext", "recorder",
    "SLOObjective", "SLOPolicy", "SLOTracker", "AlertCenter",
    "snap_to_bucket_bound",
    "prometheus_text", "start_metrics_server", "MetricsServer",
    "profiled_graph", "ProfiledGraph", "JitCostRegistry", "cost_registry",
    "compile_ledger", "compile_budget", "CompileLedger",
    "CompileBudget", "CompileBudgetExceeded",
    "stat_add", "stat_get", "stat_registry",
    "histogram_observe", "histogram_snapshot", "gauge_set",
    "metrics_snapshot",
]


def metrics_snapshot() -> dict:
    """One-call observability dump: counters, labeled gauges, histogram
    percentiles, recent-window histograms and per-program graph costs —
    what a postmortem bundle carries under ``metrics``."""
    return {
        "stats": stat_registry.stat_values(),
        "gauges": {
            name: {",".join(f"{k}={v}" for k, v in key) or "_": val
                   for key, val in g.values().items()}
            for name, g in stat_registry.labeled_gauges().items()},
        "histograms": stat_registry.histogram_snapshots(),
        "windowed": stat_registry.windowed_snapshots(),
        "jit_costs": cost_registry.snapshot(),
    }
