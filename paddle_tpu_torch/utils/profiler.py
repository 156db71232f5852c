"""Profiler — ``paddle_tpu/utils/profiler.py``'s twin (the reference
framework's profiler context and RecordEvent).

``RecordEvent`` is a span of ``profiler.tracer`` (parent links, Chrome-
trace export through ``profiler.export_chrome_trace``); while
``torch.profiler`` is recording it also enters
``torch.profiler.record_function``, so the same name brackets the
device kernels in the profiler's timeline.  Outside a recording it runs
host code only — a graphed, sync-free serving step stays so.

``start_profiler`` / ``stop_profiler`` wrap ``torch.profiler.profile``
(the CPU activity, and the CUDA one where a card is present) together
with span retention; ``timeline_path`` receives the device trace and
``profile_path`` the span table.
"""
from __future__ import annotations

import contextlib
import os

import torch

from ..profiler import chrome_trace as _chrome_trace
from ..profiler.tracer import tracer as _tracer

__all__ = ["RecordEvent", "start_profiler", "stop_profiler",
           "reset_profiler", "summary", "profiler"]

# the torch.profiler.profile session start_profiler opened (None: none)
_active_profile = None


def _torch_recording() -> bool:
    """Whether torch's profiler is recording (one C call)."""
    return torch._C._autograd._profiler_enabled()


class RecordEvent:
    """Scoped timer: a tracer span, and a ``record_function`` range
    while torch's profiler records."""

    def __init__(self, name, **args):
        self.name = name
        self._args = args or None
        self._scope = None

    def __enter__(self):
        if _torch_recording():
            self._scope = torch.profiler.record_function(self.name)
            self._scope.__enter__()
        self._span = _tracer.begin(self.name, self._args)
        return self

    def __exit__(self, *exc):
        _tracer.end(self._span)
        if self._scope is not None:
            self._scope.__exit__(*exc)
            self._scope = None
        return False


def start_profiler(state="All", tracer_option="Default", log_dir=None):
    """Start ``torch.profiler`` (CPU and, with a card, CUDA activities)
    AND span retention.  ``state``, ``tracer_option`` and ``log_dir`` are
    kept for the reference's signature: the device trace goes to
    ``stop_profiler``'s ``timeline_path``."""
    global _active_profile
    if _active_profile is not None:
        stop_profiler()
    _tracer.enable(clear=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _active_profile = prof


def stop_profiler(sorted_key=None, profile_path=None, timeline_path=None):
    """Stop tracing.  ``profile_path`` receives the span table;
    ``timeline_path`` the device trace of the ``start_profiler`` session
    (Chrome-trace JSON with the RecordEvent ranges and the kernels) or,
    when none was started, the host spans' Chrome trace."""
    global _active_profile
    prof, _active_profile = _active_profile, None
    if prof is not None:
        prof.stop()
    # symmetric with start_profiler: stop keeping spans (those kept stay
    # readable and exportable until the next enable)
    _tracer.disable()
    if timeline_path and prof is None:
        _chrome_trace.export_chrome_trace(timeline_path)
    elif timeline_path:
        d = os.path.dirname(timeline_path)
        if d:
            os.makedirs(d, exist_ok=True)
        prof.export_chrome_trace(timeline_path)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(summary(sorted_key or "total") + "\n")
    if sorted_key:
        print(summary(sorted_key))


def reset_profiler():
    _tracer.reset_aggregates()
    _tracer.clear()


def summary(sorted_key="total"):
    aggs = _tracer.aggregates()
    key_fns = {
        "total": lambda kv: -kv[1]["total_s"],
        "calls": lambda kv: -kv[1]["calls"],
        "max": lambda kv: -kv[1]["max_s"],
        "min": lambda kv: -kv[1]["min_s"],
        "ave": lambda kv: -kv[1]["avg_s"],
    }
    rows = sorted(aggs.items(), key=key_fns.get(sorted_key,
                                                key_fns["total"]))
    lines = [f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>12}"
             f"{'Min(ms)':>12}{'Max(ms)':>12}"]
    for name, a in rows:
        lines.append(
            f"{name:<40}{a['calls']:>8}{a['total_s'] * 1e3:>12.3f}"
            f"{a['avg_s'] * 1e3:>12.3f}{a['min_s'] * 1e3:>12.3f}"
            f"{a['max_s'] * 1e3:>12.3f}")
    return "\n".join(lines)


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             tracer_option="Default"):
    start_profiler(state, tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)
