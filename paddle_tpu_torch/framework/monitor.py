"""Global stat counters + distributions — the twin of
``paddle_tpu/framework/monitor.py``: process-wide named counters and
gauges (``get``), log-bucketed histograms (``histogram``), recent-window
histograms (``windowed``) that the SLO engine and the ``/healthz``
window read, and labeled gauges (``labeled_gauge``) for the fleet's
per-replica rollup.  The Prometheus text exposition over this registry
lives in ``profiler/exposition.py``."""
from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["StatRegistry", "Histogram", "WindowedHistogram",
           "LabeledGauge", "stat_registry", "stat_add", "stat_get",
           "stat_reset", "histogram_observe", "histogram_snapshot",
           "gauge_set"]


class _Stat:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def add(self, v):
        with self._lock:
            self.value += v
            return self.value

    def set(self, v):
        with self._lock:
            self.value = v

    def reset(self):
        self.set(0)

    def get(self):
        return self.value


# 20 log-spaced buckets per decade over [1e-6, 1e6): ratio 10**(1/20)
# ~= 1.122 between bounds, so a geometric-midpoint percentile estimate is
# within ~6% relative error of the exact sample percentile across 12
# decades — wide enough for microsecond latencies and token counts alike.
_BUCKETS_PER_DECADE = 20
_MIN_EXP, _MAX_EXP = -6, 6
_BOUNDS = [10.0 ** (e / _BUCKETS_PER_DECADE)
           for e in range(_MIN_EXP * _BUCKETS_PER_DECADE,
                          _MAX_EXP * _BUCKETS_PER_DECADE + 1)]


def _percentile_est(counts: List[int], total: int, vmin: float,
                    vmax: float, p: float) -> float:
    """p-th percentile estimate over one log-bucket counts array
    (geometric interpolation inside the covering bucket, clamped to the
    observed [vmin, vmax]) — shared by Histogram and WindowedHistogram
    so a merged window and a cumulative histogram agree bucket-for-
    bucket."""
    if total == 0:
        return 0.0
    rank = (p / 100.0) * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            frac = (rank - cum) / c
            lo = _BOUNDS[i - 1] if i > 0 else vmin
            hi = _BOUNDS[i] if i < len(_BOUNDS) else vmax
            if lo <= 0 or hi <= 0:
                est = lo + (hi - lo) * frac       # linear fallback
            else:
                est = lo * (hi / lo) ** frac      # geometric interp
            return min(max(est, vmin), vmax)
        cum += c
    return vmax


class Histogram:
    """Log-bucketed distribution (thread-safe).

    ``observe`` is O(log n_buckets) (bisect over the fixed bounds);
    percentiles are estimated by geometric interpolation inside the
    covering bucket and clamped to the exact observed [min, max].
    Values <= the smallest bound land in the underflow bucket, values
    beyond the largest in the overflow bucket.
    """

    __slots__ = ("_counts", "_sum", "_count", "_min", "_max", "_lock")

    def __init__(self):
        self._lock = threading.Lock()
        self._reset_locked()

    def _reset_locked(self):
        self._counts = [0] * (len(_BOUNDS) + 1)  # +1 overflow bucket
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float):
        v = float(value)
        idx = bisect.bisect_left(_BOUNDS, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def reset(self):
        with self._lock:
            self._reset_locked()

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> float:
        """Estimate the p-th percentile (p in [0, 100])."""
        with self._lock:
            return self._percentile_locked(p)

    def _percentile_locked(self, p: float) -> float:
        return _percentile_est(self._counts, self._count, self._min,
                               self._max, p)

    def count_over(self, threshold: float) -> Tuple[int, int]:
        """(samples above ``threshold``, total samples) — both monotone
        non-decreasing, the cumulative good/bad split a latency SLO
        objective differences over time windows.  Resolution is the
        bucket grid: a sample counts as "over" when its whole bucket
        lies above the threshold, so the split is EXACT whenever
        ``threshold`` is one of the log-bucket bounds (profiler.slo
        snaps objective thresholds to the grid for this reason)."""
        idx = bisect.bisect_left(_BOUNDS, float(threshold))
        with self._lock:
            return sum(self._counts[idx + 1:]), self._count

    def snapshot(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "mean": self._sum / self._count,
                "p50": self._percentile_locked(50),
                "p95": self._percentile_locked(95),
                "p99": self._percentile_locked(99),
            }

    def cumulative_buckets(self):
        """[(upper_bound, cumulative_count), ..., (inf, total)] — the
        Prometheus exposition shape.  Empty buckets are elided (except
        the final +Inf) to keep the text small."""
        return self.exposition_state()[0]

    def exposition_state(self):
        """(cumulative_buckets, sum, count) under ONE lock hold, so a
        scrape concurrent with observe() cannot emit a _count that
        disagrees with the +Inf bucket (the Prometheus histogram
        invariant)."""
        with self._lock:
            out = []
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if c and i < len(_BOUNDS):
                    out.append((_BOUNDS[i], cum))
            out.append((math.inf, cum))
            return out, self._sum, self._count


class _WindowSlice:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self):
        self.reset()

    def reset(self):
        self.counts = [0] * (len(_BOUNDS) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class WindowedHistogram:
    """RECENT-window distribution: a ring of ``slices`` rotating
    log-bucket sub-histograms (the same ``_BOUNDS`` geometry as
    ``Histogram``), merged on query — bounded memory, O(slices *
    n_buckets), regardless of traffic.

    A cumulative ``Histogram`` answers "p95 since reset"; this answers
    "p95 over the last ``window_s`` seconds": each sub-histogram covers
    ``window_s / slices`` seconds, the ring holds the most recent
    ``slices`` of them, and rotation retires the oldest slice wholesale
    (so the effective window is window_s ± one slice).

    All rotation is driven by the INJECTED monotonic clock (constructor
    ``clock=``; default ``time.monotonic``) — no ambient clock read in
    control flow, so the class is DT002-clean by construction and fully
    drivable by a fake clock in tests.  Thread-safe like the other
    registry primitives.
    """

    __slots__ = ("_window_s", "_slices", "_slice_s", "_clock", "_ring",
                 "_epoch", "_lock")

    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, window_s: float = 60.0, slices: int = 6,
                 clock: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self._configure_locked(window_s, slices, clock)

    def _configure_locked(self, window_s, slices, clock):
        window_s = float(window_s)
        slices = int(slices)
        if window_s <= 0 or slices < 1:
            raise ValueError(
                f"window_s must be > 0 and slices >= 1, "
                f"got window_s={window_s!r} slices={slices!r}")
        self._window_s = window_s
        self._slices = slices
        self._slice_s = window_s / slices
        self._clock = clock if clock is not None else time.monotonic
        self._ring = [_WindowSlice() for _ in range(slices)]
        self._epoch: Optional[int] = None

    def configure(self, window_s: Optional[float] = None,
                  slices: Optional[int] = None,
                  clock: Optional[Callable[[], float]] = None):
        """Re-bind window geometry and/or clock, DISCARDING samples —
        the registry caches instances by name, so an owner that wants a
        different clock (e.g. a fake one in tests) reconfigures the
        cached instance rather than leaking a second registry entry."""
        with self._lock:
            self._configure_locked(
                self._window_s if window_s is None else window_s,
                self._slices if slices is None else slices,
                self._clock if clock is None else clock)

    @property
    def window_s(self) -> float:
        return self._window_s

    @property
    def slices(self) -> int:
        return self._slices

    def _advance_locked(self, now: float):
        epoch = int(now // self._slice_s)
        if self._epoch is None:
            self._epoch = epoch
            return
        gap = epoch - self._epoch
        if gap <= 0:
            return
        if gap >= self._slices:
            for s in self._ring:
                s.reset()
        else:
            for e in range(self._epoch + 1, epoch + 1):
                self._ring[e % self._slices].reset()
        self._epoch = epoch

    def observe(self, value: float, now: Optional[float] = None):
        v = float(value)
        idx = bisect.bisect_left(_BOUNDS, v)
        if now is None:
            now = self._clock()
        with self._lock:
            self._advance_locked(now)
            s = self._ring[self._epoch % self._slices]
            s.counts[idx] += 1
            s.sum += v
            s.count += 1
            if v < s.min:
                s.min = v
            if v > s.max:
                s.max = v

    def reset(self):
        with self._lock:
            for s in self._ring:
                s.reset()
            self._epoch = None

    def _merged_locked(self):
        counts = [0] * (len(_BOUNDS) + 1)
        total, vsum = 0, 0.0
        vmin, vmax = math.inf, -math.inf
        for s in self._ring:
            if not s.count:
                continue
            for i, c in enumerate(s.counts):
                if c:
                    counts[i] += c
            total += s.count
            vsum += s.sum
            vmin = min(vmin, s.min)
            vmax = max(vmax, s.max)
        return counts, total, vsum, vmin, vmax

    def percentile(self, p: float, now: Optional[float] = None) -> float:
        """p-th percentile (p in [0, 100]) over the current window."""
        if now is None:
            now = self._clock()
        with self._lock:
            self._advance_locked(now)
            counts, total, _, vmin, vmax = self._merged_locked()
        return _percentile_est(counts, total, vmin, vmax, p)

    def snapshot(self, now: Optional[float] = None) -> dict:
        if now is None:
            now = self._clock()
        with self._lock:
            self._advance_locked(now)
            counts, total, vsum, vmin, vmax = self._merged_locked()
        if total == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                    "window_s": self._window_s}
        return {
            "count": total,
            "sum": vsum,
            "min": vmin,
            "max": vmax,
            "mean": vsum / total,
            "p50": _percentile_est(counts, total, vmin, vmax, 50),
            "p95": _percentile_est(counts, total, vmin, vmax, 95),
            "p99": _percentile_est(counts, total, vmin, vmax, 99),
            "window_s": self._window_s,
        }

    def exposition_state(self, now: Optional[float] = None):
        """([(quantile, value), ...], sum, count) under ONE lock hold —
        the Prometheus *summary* shape (a windowed distribution is what
        a summary's sliding-window quantiles mean, vs the cumulative
        histogram families)."""
        if now is None:
            now = self._clock()
        with self._lock:
            self._advance_locked(now)
            counts, total, vsum, vmin, vmax = self._merged_locked()
        quants = [(q, _percentile_est(counts, total, vmin, vmax, q * 100))
                  for q in self.QUANTILES]
        return quants, vsum, total


class LabeledGauge:
    """A gauge family: one float per label-set (thread-safe)."""

    __slots__ = ("_values", "_lock")

    def __init__(self):
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(labels: dict) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def set(self, value: float, **labels):
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def add(self, value: float, **labels) -> float:
        """Read-modify-write under the lock (two frontend threads doing
        get()+set() would lose increments)."""
        with self._lock:
            k = self._key(labels)
            v = self._values.get(k, 0.0) + float(value)
            self._values[k] = v
            return v

    def get(self, **labels) -> Optional[float]:
        with self._lock:
            return self._values.get(self._key(labels))

    def values(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        with self._lock:
            return dict(self._values)

    def reset(self):
        with self._lock:
            self._values.clear()


class StatRegistry:
    """Named counters (monitor.h:77) + histograms + labeled gauges."""

    def __init__(self):
        self._stats: Dict[str, _Stat] = {}
        self._hists: Dict[str, Histogram] = {}
        self._gauges: Dict[str, LabeledGauge] = {}
        self._windowed: Dict[str, WindowedHistogram] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> _Stat:
        with self._lock:
            s = self._stats.get(name)
            if s is None:
                s = self._stats[name] = _Stat()
            return s

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    def labeled_gauge(self, name: str) -> LabeledGauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = LabeledGauge()
            return g

    def windowed(self, name: str, window_s: float = 60.0,
                 slices: int = 6,
                 clock: Optional[Callable[[], float]] = None
                 ) -> WindowedHistogram:
        """Named recent-window histogram; the FIRST caller's geometry
        and clock stick (like every other accessor here) — owners that
        need a different clock call ``.configure(...)`` on the cached
        instance."""
        with self._lock:
            h = self._windowed.get(name)
            if h is None:
                h = self._windowed[name] = WindowedHistogram(
                    window_s, slices, clock=clock)
            return h

    def stat_values(self) -> Dict[str, int]:
        with self._lock:
            return {n: s.get() for n, s in self._stats.items()}

    def histogram_snapshots(self) -> Dict[str, dict]:
        with self._lock:
            hists = list(self._hists.items())
        return {n: h.snapshot() for n, h in hists}

    def histograms(self) -> Dict[str, Histogram]:
        with self._lock:
            return dict(self._hists)

    def labeled_gauges(self) -> Dict[str, LabeledGauge]:
        with self._lock:
            return dict(self._gauges)

    def windowed_histograms(self) -> Dict[str, WindowedHistogram]:
        with self._lock:
            return dict(self._windowed)

    def windowed_snapshots(self) -> Dict[str, dict]:
        with self._lock:
            hists = list(self._windowed.items())
        return {n: h.snapshot() for n, h in hists}

    def reset_all(self):
        with self._lock:
            for s in self._stats.values():
                s.reset()
            for h in self._hists.values():
                h.reset()
            for g in self._gauges.values():
                g.reset()
            for w in self._windowed.values():
                w.reset()


stat_registry = StatRegistry()


def stat_add(name: str, value=1):
    """STAT_ADD analog (monitor.h:130)."""
    return stat_registry.get(name).add(value)


def stat_get(name: str):
    return stat_registry.get(name).get()


def stat_reset(name: str):
    stat_registry.get(name).reset()


def histogram_observe(name: str, value: float):
    """Record one sample into the named process-wide histogram."""
    stat_registry.histogram(name).observe(value)


def histogram_snapshot(name: str) -> dict:
    """count/sum/min/max/mean/p50/p95/p99 of the named histogram."""
    return stat_registry.histogram(name).snapshot()


def gauge_set(name: str, value: float, **labels):
    """Set the named (optionally labeled) gauge to ``value``."""
    stat_registry.labeled_gauge(name).set(value, **labels)
