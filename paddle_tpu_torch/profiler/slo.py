"""Fleet SLO engine: objectives, error budgets, burn-rate alerts — the
twin of ``paddle_tpu/profiler/slo.py``.

Turns the raw counters/histograms the serving stack already emits into
OBJECTIVES — "99.9% of requests succeed", "95% of first tokens arrive
within 500 ms" — evaluated with the classic multi-window multi-burn-rate
rule (Google SRE workbook ch.5): an alert pages only when BOTH a fast
and a slow window burn error budget faster than ``burn_threshold``×
the sustainable rate, so a single bad second doesn't page but a sustained
regression pages within the fast window.

Two objective kinds, one evaluation path:

- ``error_budget``: bad/total outcome COUNTERS (e.g. failures vs
  submissions).  Error rate over a window W is the counter delta ratio
  between now and now−W.
- ``latency``: a cumulative latency histogram + a threshold.  The
  threshold is snapped to the log-bucket grid
  (``snap_to_bucket_bound``), which makes ``Histogram.count_over`` an
  EXACT monotone bad-outcome counter — a latency objective is then just
  an error budget over (samples over threshold, samples).

Everything is driven by an INJECTED monotonic clock: the tracker keeps
(timestamp, bad, total) samples per objective, and tests drill hours of
budget in milliseconds by feeding a fake clock.  Evaluation is
deterministic given the counter sequence and the clock — the
double-drive discipline (docs/OBSERVABILITY.md) applies to the
``healthz()["slo"]`` payload too.

Alert transitions (fire/clear, with hysteresis) land in the flight
recorder (``slo.fire`` / ``slo.clear`` fleet transitions), active
alerts are stamped into crash postmortem bundles via the tracker's
context provider, and per-objective state is exported as
``serving.slo.*`` labeled gauges through the Prometheus exposition.
"""
from __future__ import annotations

import bisect
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..framework.concurrency import OrderedLock
from ..framework.errors import InvalidArgumentError
from ..framework.monitor import _BOUNDS, stat_registry
from .flight_recorder import recorder as flight

__all__ = ["SLOObjective", "SLOPolicy", "AlertCenter", "SLOTracker",
           "snap_to_bucket_bound"]

ALERT_OK = "ok"
ALERT_FIRING = "firing"


def snap_to_bucket_bound(value: float) -> float:
    """Nearest log-bucket bound to ``value`` — latency thresholds snap
    to the grid so the over/under split is exact (see
    ``Histogram.count_over``), not smeared across one bucket."""
    v = float(value)
    idx = bisect.bisect_left(_BOUNDS, v)
    if idx <= 0:
        return _BOUNDS[0]
    if idx >= len(_BOUNDS):
        return _BOUNDS[-1]
    lo, hi = _BOUNDS[idx - 1], _BOUNDS[idx]
    return lo if (v - lo) <= (hi - v) else hi


@dataclass(frozen=True)
class SLOObjective:
    """One declarative objective.

    ``target`` is the GOOD fraction promised (0.999 = "three nines");
    the error budget is ``1 - target``.  ``kind``:

    - ``"error_budget"``: ``bad``/``total`` name registry COUNTERS
      (each side summed when several are given).
    - ``"latency"``: ``histogram`` names a cumulative registry latency
      histogram (ms samples) and ``threshold_ms`` the bound; ``target``
      is the fraction of samples that must land at or under it (0.95 +
      500 ms = "p95 TTFT ≤ 500 ms").
    """

    name: str
    target: float
    kind: str = "error_budget"
    bad: Tuple[str, ...] = ()
    total: Tuple[str, ...] = ()
    histogram: str = ""
    threshold_ms: float = 0.0
    description: str = ""

    def __post_init__(self):
        if not self.name:
            raise InvalidArgumentError("objective needs a name")
        if not (0.0 < self.target < 1.0):
            raise InvalidArgumentError(
                f"objective {self.name!r}: target must be in (0, 1), "
                f"got {self.target!r}")
        if self.kind == "error_budget":
            if not self.bad or not self.total:
                raise InvalidArgumentError(
                    f"objective {self.name!r}: error_budget needs bad= "
                    "and total= counter names")
        elif self.kind == "latency":
            if not self.histogram or self.threshold_ms <= 0:
                raise InvalidArgumentError(
                    f"objective {self.name!r}: latency needs histogram= "
                    "and threshold_ms > 0")
            # snap once at construction; dataclass is frozen
            object.__setattr__(self, "threshold_ms",
                               snap_to_bucket_bound(self.threshold_ms))
        else:
            raise InvalidArgumentError(
                f"objective {self.name!r}: kind must be 'error_budget' "
                f"or 'latency', got {self.kind!r}")

    def read(self) -> Tuple[int, int]:
        """Current cumulative (bad, total) outcome counts."""
        if self.kind == "latency":
            return stat_registry.histogram(self.histogram).count_over(
                self.threshold_ms)
        bad = sum(stat_registry.get(n).get() for n in self.bad)
        total = sum(stat_registry.get(n).get() for n in self.total)
        return int(bad), int(total)


@dataclass(frozen=True)
class SLOPolicy:
    """Objectives + the shared multi-window multi-burn-rate rule.

    An objective PAGES when the burn rate — window error rate divided
    by the budget rate ``1 - target`` — exceeds ``burn_threshold`` in
    BOTH the fast and slow windows for ``fire_after`` consecutive
    evaluations; it CLEARS after ``clear_after`` consecutive
    evaluations with the fast-window burn back under the threshold
    (slow-window burn decays too slowly to gate clearing — the fast
    window is the standard short-circuit).  ``budget_window_s`` is the
    accounting period for attainment / budget-remaining.  All windows
    are measured on the tracker's injected clock, so tests compress
    them arbitrarily.
    """

    objectives: Tuple[SLOObjective, ...]
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    budget_window_s: float = 3600.0
    burn_threshold: float = 10.0
    fire_after: int = 2
    clear_after: int = 3
    eval_interval_s: float = 1.0

    def __post_init__(self):
        if not self.objectives:
            raise InvalidArgumentError("policy needs >= 1 objective")
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise InvalidArgumentError(
                f"duplicate objective names: {names}")
        if not (0 < self.fast_window_s <= self.slow_window_s
                <= self.budget_window_s):
            raise InvalidArgumentError(
                "windows must satisfy 0 < fast <= slow <= budget, got "
                f"{self.fast_window_s}/{self.slow_window_s}/"
                f"{self.budget_window_s}")
        if self.burn_threshold <= 1.0:
            raise InvalidArgumentError(
                "burn_threshold must be > 1 (1.0 = exactly on budget)")
        if self.fire_after < 1 or self.clear_after < 1:
            raise InvalidArgumentError(
                "fire_after/clear_after must be >= 1")

    @staticmethod
    def default(**overrides) -> "SLOPolicy":
        """The stock serving policy: availability, deadline, numeric
        quarantine error budgets over the frontend/engine counters the
        stack already emits, plus a p95 TTFT latency objective.
        Keyword overrides (window/threshold/hysteresis knobs) forward
        to the ``SLOPolicy`` constructor and are validated there."""
        return SLOPolicy(**overrides, objectives=(
            SLOObjective(
                name="availability", target=0.999,
                bad=("serving.frontend.failures",),
                total=("serving.frontend.submitted",),
                description="requests must not fail (replica death "
                            "with no survivor, internal errors)"),
            SLOObjective(
                name="deadline", target=0.99,
                bad=("serving.frontend.deadline_miss",),
                total=("serving.frontend.submitted",),
                description="requests must finish inside their "
                            "deadline"),
            SLOObjective(
                name="nan_quarantine", target=0.999,
                bad=("serving.guard.quarantines",),
                total=("serving.requests_admitted",),
                description="admitted requests must not be quarantined "
                            "by the numeric guards"),
            SLOObjective(
                name="ttft_p95", target=0.95, kind="latency",
                histogram="serving.frontend.ttft_ms",
                threshold_ms=1000.0,
                description="95% of first tokens within ~1 s"),
        ))


class _AlertState:
    __slots__ = ("state", "fire_streak", "clear_streak", "since",
                 "last_fed")

    def __init__(self):
        self.state = ALERT_OK
        self.fire_streak = 0
        self.clear_streak = 0
        self.since: Optional[float] = None
        self.last_fed: Optional[float] = None


class AlertCenter:
    """Firing/clearing hysteresis over per-objective page verdicts.

    ``feed(name, page_both, page_fast, now, detail)`` advances one
    objective's state machine and returns the (possibly new) state.
    Transitions emit ``slo.fire`` / ``slo.clear`` into the flight
    recorder's fleet-transition ring and count into
    ``serving.slo.alerts_fired`` / ``serving.slo.alerts_cleared``; the
    bounded ``log`` keeps the recent transitions for the dashboard's
    alert log.  NOT thread-safe on its own — the owning tracker
    serializes access under its lock.
    """

    def __init__(self, fire_after: int = 2, clear_after: int = 3,
                 log_size: int = 64):
        self.fire_after = max(1, int(fire_after))
        self.clear_after = max(1, int(clear_after))
        self._states: Dict[str, _AlertState] = {}
        self.log: Deque[dict] = deque(maxlen=int(log_size))

    def _st(self, name: str) -> _AlertState:
        st = self._states.get(name)
        if st is None:
            st = self._states[name] = _AlertState()
        return st

    def feed(self, name: str, page_both: bool, page_fast: bool,
             now: float, detail: str = "") -> str:
        st = self._st(name)
        if st.last_fed is not None and now <= st.last_fed:
            # same-tick re-scrape (two healthz polls between clock
            # advances): the window sample was replaced, so the verdict
            # carries no new evidence — advancing the streak here would
            # let poll frequency, not time, drive the hysteresis
            return st.state
        st.last_fed = now
        if st.state == ALERT_OK:
            st.fire_streak = st.fire_streak + 1 if page_both else 0
            if st.fire_streak >= self.fire_after:
                st.state = ALERT_FIRING
                st.since = now
                st.fire_streak = 0
                st.clear_streak = 0
                self._transition("slo.fire", name, now, detail)
                stat_registry.get("serving.slo.alerts_fired").add(1)
        else:
            st.clear_streak = 0 if page_fast else st.clear_streak + 1
            if st.clear_streak >= self.clear_after:
                st.state = ALERT_OK
                st.since = now
                st.fire_streak = 0
                st.clear_streak = 0
                self._transition("slo.clear", name, now, detail)
                stat_registry.get("serving.slo.alerts_cleared").add(1)
        return st.state

    def _transition(self, kind: str, name: str, now: float, detail: str):
        flight.on_transition(kind, name, detail)
        self.log.append({"at": now, "kind": kind, "objective": name,
                         "detail": detail})

    def state(self, name: str) -> str:
        st = self._states.get(name)
        return ALERT_OK if st is None else st.state

    def firing(self) -> List[str]:
        return sorted(n for n, st in self._states.items()
                      if st.state == ALERT_FIRING)

    def reset(self):
        self._states.clear()
        self.log.clear()


class SLOTracker:
    """Evaluates an ``SLOPolicy`` against the live registry.

    ``evaluate()`` reads each objective's cumulative (bad, total),
    appends a (t, bad, total) sample, and differences the series over
    the fast/slow/budget windows — bounded memory (samples older than
    the budget window are dropped, keeping one baseline), deterministic
    given the counter sequence and the injected clock.  Thread-safe:
    pump threads (``maybe_evaluate``) and healthz/scrape threads
    (``evaluate``) race freely.
    """

    COUNTERS = ("serving.slo.alerts_fired", "serving.slo.alerts_cleared")
    LABELED = ("serving.slo.attainment", "serving.slo.burn_rate",
               "serving.slo.budget_remaining", "serving.slo.alert")

    def __init__(self, policy: Optional[SLOPolicy] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.policy = policy or SLOPolicy.default()
        self._clock = clock if clock is not None else time.monotonic
        self._lock = OrderedLock("serving.slo")
        self.alerts = AlertCenter(fire_after=self.policy.fire_after,
                                  clear_after=self.policy.clear_after)
        self._samples: Dict[str, Deque[Tuple[float, int, int]]] = {
            o.name: deque() for o in self.policy.objectives}
        self._last_eval: Optional[float] = None
        self._last_result: Dict[str, dict] = {}
        for name in self.COUNTERS:
            stat_registry.get(name).reset()
        for name in self.LABELED:
            stat_registry.labeled_gauge(name).reset()

    # --- evaluation ---------------------------------------------------------
    @staticmethod
    def _window_rate(dq, now: float, window_s: float
                     ) -> Tuple[float, int, int]:
        """(error_rate, d_bad, d_total) between ``now`` and the best
        baseline for ``now - window_s`` (latest sample at or before it;
        the oldest sample when history is shorter than the window)."""
        head = dq[-1]
        base = dq[0]
        cutoff = now - window_s
        # dq is small (trimmed to the budget window at eval cadence) —
        # linear scan newest→oldest for the baseline
        for s in reversed(dq):
            if s[0] <= cutoff:
                base = s
                break
        d_bad = head[1] - base[1]
        d_total = head[2] - base[2]
        rate = (d_bad / d_total) if d_total > 0 else 0.0
        return rate, d_bad, d_total

    def _trim(self, dq, now: float):
        horizon = now - self.policy.budget_window_s
        while len(dq) >= 2 and dq[1][0] <= horizon:
            dq.popleft()

    def evaluate(self, now: Optional[float] = None) -> Dict[str, dict]:
        """One evaluation pass over every objective; returns (and
        caches) the per-objective payload ``healthz()["slo"]``
        embeds."""
        if now is None:
            now = self._clock()
        pol = self.policy
        budget_rate = None
        out: Dict[str, dict] = {}
        with self._lock:
            self._last_eval = now
            for obj in pol.objectives:
                bad, total = obj.read()
                dq = self._samples[obj.name]
                if dq and dq[-1][0] >= now:
                    # clock did not advance since the last sample (two
                    # scrapes inside one tick): replace, don't stack
                    dq.pop()
                dq.append((now, bad, total))
                self._trim(dq, now)
                budget_rate = 1.0 - obj.target
                rate_fast, _, _ = self._window_rate(
                    dq, now, pol.fast_window_s)
                rate_slow, _, _ = self._window_rate(
                    dq, now, pol.slow_window_s)
                rate_budget, _, _ = self._window_rate(
                    dq, now, pol.budget_window_s)
                burn_fast = rate_fast / budget_rate
                burn_slow = rate_slow / budget_rate
                page_fast = burn_fast > pol.burn_threshold
                page_both = page_fast and burn_slow > pol.burn_threshold
                attainment = 1.0 - rate_budget
                budget_remaining = 1.0 - rate_budget / budget_rate
                state = self.alerts.feed(
                    obj.name, page_both, page_fast, now,
                    detail=f"burn_fast={burn_fast:.2f} "
                           f"burn_slow={burn_slow:.2f} "
                           f"threshold={pol.burn_threshold:g}")
                out[obj.name] = {
                    "kind": obj.kind,
                    "target": obj.target,
                    "attainment": attainment,
                    "budget_remaining": budget_remaining,
                    "burn_rate": burn_fast,
                    "burn_rate_slow": burn_slow,
                    "alert": state,
                }
                if obj.kind == "latency":
                    out[obj.name]["threshold_ms"] = obj.threshold_ms
            self._last_result = out
        for name, st in out.items():
            stat_registry.labeled_gauge("serving.slo.attainment").set(
                st["attainment"], objective=name)
            stat_registry.labeled_gauge("serving.slo.burn_rate").set(
                st["burn_rate"], objective=name)
            stat_registry.labeled_gauge(
                "serving.slo.budget_remaining").set(
                st["budget_remaining"], objective=name)
            stat_registry.labeled_gauge("serving.slo.alert").set(
                1.0 if st["alert"] == ALERT_FIRING else 0.0,
                objective=name)
        return out

    def maybe_evaluate(self) -> Optional[Dict[str, dict]]:
        """Throttled evaluation for hot-loop callers (the frontend pump
        ticks this): runs at most once per ``eval_interval_s`` of the
        injected clock, None when skipped."""
        now = self._clock()
        with self._lock:
            last = self._last_eval
        if last is not None and now - last < self.policy.eval_interval_s:
            return None
        return self.evaluate(now=now)

    # --- read side ----------------------------------------------------------
    def status(self) -> Dict[str, dict]:
        """Last evaluation's payload (empty before the first)."""
        with self._lock:
            return dict(self._last_result)

    def active_alerts(self) -> List[str]:
        with self._lock:
            return self.alerts.firing()

    def alert_log(self) -> List[dict]:
        with self._lock:
            return list(self.alerts.log)

    def context(self) -> dict:
        """Flight-recorder context provider: stamped into every crash
        postmortem bundle, so the dump says which SLOs were burning
        when the replica died."""
        with self._lock:
            return {
                "active_alerts": self.alerts.firing(),
                "objectives": dict(self._last_result),
                "alert_log": list(self.alerts.log),
            }

    # --- adaptive brownout (opt-in; frontend slo_adaptive_brownout) ---------
    def brownout_pressure_floor(self, brownout_policy) -> float:
        """Map the firing alert set to a queue-pressure FLOOR for the
        BrownoutController: no alert → 0 (brownout sees real pressure
        only); an alert firing → at least the shed stage; fast burn at
        2× the page threshold → at least the clamp stage.  The floor
        composes with real pressure via max(), so it can only ever
        ESCALATE — and the knob is off by default, leaving byte-
        identity suites untouched."""
        with self._lock:
            firing = self.alerts.firing()
            if not firing:
                return 0.0
            worst = max(self._last_result[n]["burn_rate"]
                        for n in firing if n in self._last_result)
        if worst >= 2.0 * self.policy.burn_threshold:
            return brownout_policy.clamp_at
        return brownout_policy.shed_at

    def reset(self):
        """Forget samples and alert state (test isolation between
        drives — the registry counters are reset by their owners)."""
        with self._lock:
            for dq in self._samples.values():
                dq.clear()
            self.alerts.reset()
            self._last_eval = None
            self._last_result = {}
        for name in self.COUNTERS:
            stat_registry.get(name).reset()
        for name in self.LABELED:
            stat_registry.labeled_gauge(name).reset()
