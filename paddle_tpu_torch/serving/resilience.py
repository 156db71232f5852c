"""Resilience policy: request snapshots, the watchdog and the overload
brownout — ``paddle_tpu/serving/resilience.py``.

Plain thread-free objects, so every state machine is testable without
engines, threads or devices:

- :class:`EngineSnapshot` — the portable checkpoint of one in-flight
  request (consumed tokens + KV pages), made by
  ``ServingEngine.snapshot`` and consumed by ``ServingEngine.restore`` on
  another engine: warm failover resumes mid-stream from the checkpoint
  instead of replaying from token 0.  ``to_state`` / ``from_state`` are
  its plain form (numpy leaves and Python scalars), the same as the JAX
  package's: a snapshot of either package restores in the other.
- :class:`Watchdog` — per-replica overdue-step detection with a threshold
  from a rolling p99 of step latencies, suspect-to-dead escalation and
  exponential backoff before a recovered replica is re-admitted.
- :class:`BrownoutController` — staged overload degradation (shed, then
  clamp ``max_new_tokens``, then reject), driven by sustained pressure
  with hysteresis on both edges, exported as the
  ``serving.brownout_stage`` gauge.

The frontend that drives the watchdog and the brownout (ROADMAP queue 1
step C item 4), and writing snapshots to disk through a checkpoint
store, are not in this slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..framework.concurrency import OrderedLock
from ..framework.monitor import stat_registry
from ..profiler.flight_recorder import recorder as flight

__all__ = ["EngineSnapshot", "WatchdogConfig", "Watchdog",
           "BrownoutPolicy", "BrownoutController",
           "BROWNOUT_NORMAL", "BROWNOUT_SHED", "BROWNOUT_CLAMP",
           "BROWNOUT_REJECT", "BROWNOUT_STAGES"]


# =============================================================================
# Engine state checkpoint
# =============================================================================
@dataclass
class EngineSnapshot:
    """Checkpoint of one in-flight request, portable across replicas.

    The paged KV cache makes this cheap and exact: a request's device
    state is exactly (a) its consumed tokens, (b) the KV positions
    written so far, and (c) the pages holding them — all enumerable from
    the host page table.  ``pages`` holds, per layer and side, the
    ``[R, page_size, H, D]`` page payloads covering positions
    ``[0, pos)``.

    KV-mode contract:

    - ``native``       pages are the model dtype, restored verbatim —
                       the resumed stream is BYTE-IDENTICAL to the
                       uninterrupted one.
    - ``int8_static``  pages are raw int8; the calibrated static scales
                       are engine configuration (identical on every
                       replica built from the same export), so they ride
                       along implicitly and restore is BYTE-IDENTICAL.
    - ``int8_dynamic`` pages are stored DEQUANTIZED (fp32): dynamic
                       per-page scales are device state owned by the
                       donor's page pool, so restore re-derives fresh
                       abs-max scales from the page content and
                       requantizes.  Equal within quantization noise;
                       byte-identity is NOT guaranteed in this mode
                       (use static scales when failover must be exact).

    Prefix-cache interaction: a sequence holding SHARED pages from
    the donor's radix index snapshots them exactly like owned pages —
    the gather walks the host page table, which does not distinguish —
    and ``restore`` re-admits every page as PRIVATE (the resume
    admission path never consults the survivor's index).  Failover
    therefore never depends on the survivor having (or lacking) any
    index state; the survivor's own prefix cache warms up from its own
    traffic.
    """

    request_id: str
    prompt: np.ndarray                  # [P] int32
    max_new_tokens: int
    deadline: Optional[float]           # absolute monotonic (rides along:
    #                                     failover never extends an SLO)
    generated: np.ndarray               # [g] int32 consumed at snapshot
    pos: int                            # KV positions written (= resume pos)
    kv_mode: str                        # native | int8_static | int8_dynamic
    page_size: int
    pages: Dict[str, List[np.ndarray]]  # {"k": [L x [R,P,H,D]], "v": ...}
    nbytes: int = 0
    created_at: float = field(default_factory=time.monotonic)
    # speculative-decoding drafter state: the lane's
    # adaptive throttle (plain python scalars, Drafter.export_lane) —
    # a resumed request keeps drafting exactly where the donor left
    # off, so a seeded chaos replay reproduces the same
    # drafted/accepted counts across a failover.  None/{} when the
    # donor engine ran without speculation; ignored by engines that do.
    spec: Optional[dict] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        self.generated = np.asarray(self.generated, np.int32).reshape(-1)
        if not self.nbytes:
            self.nbytes = int(sum(p.nbytes for side in self.pages.values()
                                  for p in side))

    @property
    def num_generated(self) -> int:
        return int(self.generated.size)

    @property
    def next_token(self) -> int:
        """The token the next decode step consumes at ``pos``."""
        if self.generated.size:
            return int(self.generated[-1])
        return int(self.prompt[-1])

    @property
    def kv_len(self) -> int:
        """KV positions the snapshot's pages cover (= ``pos``)."""
        return int(self.pos)

    @property
    def num_pages(self) -> int:
        return len(self.pages["k"][0]) if self.pages.get("k") else 0

    # --- durable form (disk-backed restart recovery) ------------------------
    SNAP_SCHEMA = 1

    def to_state(self) -> dict:
        """Plain tree of numpy leaves + python scalars for a
        CheckpointStore named slot.  The absolute-monotonic ``deadline``
        does NOT survive a process restart (the clock resets), so the
        durable form carries the REMAINING budget at persist time PLUS
        a wall-clock persist timestamp: restore charges the elapsed
        wall time (post-persist decode + downtime) against the budget
        before re-anchoring to the new process's clock — restart
        recovery never extends an SLO."""
        remaining = (None if self.deadline is None
                     else max(0.0, self.deadline - time.monotonic()))
        return {
            "schema": self.SNAP_SCHEMA,
            "persisted_unix": time.time(),
            "request_id": self.request_id,
            "prompt": np.asarray(self.prompt, np.int32),
            "max_new_tokens": int(self.max_new_tokens),
            "deadline_remaining_s": remaining,
            "generated": np.asarray(self.generated, np.int32),
            "pos": int(self.pos),
            "kv_mode": self.kv_mode,
            "page_size": int(self.page_size),
            "pages": {side: [np.asarray(p) for p in arrs]
                      for side, arrs in self.pages.items()},
            "spec": dict(self.spec) if self.spec else None,
        }

    @classmethod
    def from_state(cls, state: dict,
                   now: Optional[float] = None) -> "EngineSnapshot":
        from ..framework.errors import CheckpointIncompatibleError

        schema = int(state.get("schema", -1))
        if schema > cls.SNAP_SCHEMA:
            raise CheckpointIncompatibleError(
                f"engine snapshot schema {schema} is newer than this "
                f"build's {cls.SNAP_SCHEMA}")
        now = time.monotonic() if now is None else now
        remaining = state.get("deadline_remaining_s")
        if remaining is not None:
            # charge the wall time since persist (decode after the
            # snapshot + the downtime itself) against the budget; a
            # skewed wall clock degrades to the persist-time budget at
            # worst (elapsed clamped at >= 0)
            persisted = state.get("persisted_unix")
            if persisted is not None:
                remaining = max(
                    0.0, float(remaining)
                    - max(0.0, time.time() - float(persisted)))
        return cls(
            request_id=state["request_id"],
            prompt=np.asarray(state["prompt"], np.int32),
            max_new_tokens=int(state["max_new_tokens"]),
            deadline=None if remaining is None else now + float(remaining),
            generated=np.asarray(state["generated"], np.int32),
            pos=int(state["pos"]),
            kv_mode=state["kv_mode"],
            page_size=int(state["page_size"]),
            pages={side: [np.asarray(p) for p in arrs]
                   for side, arrs in state["pages"].items()},
            spec=state.get("spec"))


# =============================================================================
# Watchdog: hung / overdue step detection
# =============================================================================
WD_OK = "ok"
WD_SUSPECT = "suspect"
WD_DEAD = "dead"
WD_READMIT = "readmit"


@dataclass
class WatchdogConfig:
    """Thresholds for hung/overdue engine-step detection.

    The overdue threshold adapts to the workload: ``max(min_threshold_s,
    p99_multiplier * rolling-p99(step latency))`` over the replica's
    last ``window`` steps — a replica serving 5 ms steps is suspect
    after ~tens of ms, one legitimately chewing 2 s prefills is not.
    ``hang_timeout_s`` is the hard ceiling: a step overdue that long is
    a hang, the replica is declared dead and its requests fail over.

    A COLD replica (no completed step observed yet) is exempt from both
    thresholds except the ``cold_grace_s`` ceiling: its first step
    includes compilation or graph capture, which
    would otherwise false-SUSPECT — or past ``hang_timeout_s`` falsely
    kill — every replica in a freshly started fleet.

    Numeric-fault channel: the frontend reports every
    guard-quarantined request via ``note_numeric_fault``.  One NaN lane
    is a damaged REQUEST; a replica producing them repeatedly is
    damaged HARDWARE/state (bad HBM, a corrupted weight buffer) —
    ``numeric_fault_suspect`` faults within ``numeric_fault_window_s``
    pull the replica from the routing pool, ``numeric_fault_dead``
    declare it dead so warm failover moves its victims to healthy
    survivors.
    """

    min_threshold_s: float = 0.25
    p99_multiplier: float = 8.0
    hang_timeout_s: float = 30.0
    cold_grace_s: float = 120.0
    window: int = 128
    backoff_initial_s: float = 0.25
    backoff_max_s: float = 30.0
    check_interval_s: float = 0.02
    numeric_fault_suspect: int = 2
    numeric_fault_dead: int = 4
    numeric_fault_window_s: float = 60.0


class _ReplicaWatch:
    __slots__ = ("latencies", "trips", "suspect_since", "backoff_until",
                 "numeric_faults")

    def __init__(self):
        self.latencies: List[float] = []
        self.trips = 0
        self.suspect_since: Optional[float] = None
        self.backoff_until: Optional[float] = None
        # monotonic timestamps of guard-quarantined requests
        self.numeric_faults: List[float] = []


class Watchdog:
    """Per-replica overdue-step state machine (logic only, no threads —
    the frontend's monitor thread drives ``check``; unit tests drive it
    with synthetic clocks).

    Verdicts from ``check(replica_id, busy_for, now, idle)``:

    - ``ok``       nothing to do
    - ``suspect``  the current step is overdue: pull the replica from
                   the routing pool (first verdict per incident — the
                   caller marks the router state and counts
                   ``serving.watchdog_trips``)
    - ``dead``     overdue past ``hang_timeout_s``: declare the replica
                   dead and fail its requests over
    - ``readmit``  a previously-suspect replica finished its step and
                   its exponential backoff has elapsed: return it to
                   the routing pool (backoff doubles per trip —
                   ``backoff_initial_s * 2^(trips-1)``, capped)
    """

    def __init__(self, config: Optional[WatchdogConfig] = None):
        self.config = config or WatchdogConfig()
        self._watch: Dict[str, _ReplicaWatch] = {}
        # pump threads observe_step() while the monitor thread reads the
        # rolling window through check()/threshold_s() — an unguarded
        # list shrink mid-np.asarray would crash the monitor
        self._lock = OrderedLock("serving.watchdog")

    def _w(self, replica_id: str) -> _ReplicaWatch:
        w = self._watch.get(replica_id)
        if w is None:
            w = self._watch[replica_id] = _ReplicaWatch()
        return w

    def observe_step(self, replica_id: str, seconds: float,
                     now: Optional[float] = None):
        """Record one completed step's latency (rolling window).  A
        completed step is also RECOVERY EVIDENCE for a suspect replica:
        it arms the re-admission backoff, so a replica that stays
        continuously busy (back-to-back steps, never sampled idle) can
        still be re-admitted from ``check``'s busy branch."""
        with self._lock:
            w = self._w(replica_id)
            w.latencies.append(float(seconds))
            if len(w.latencies) > self.config.window:
                del w.latencies[: -self.config.window]
            if w.suspect_since is not None and w.backoff_until is None:
                now = time.monotonic() if now is None else now
                w.backoff_until = now + self._backoff_s_locked(w)

    def note_numeric_fault(self, replica_id: str,
                           now: Optional[float] = None):
        """Record one guard-quarantined request on ``replica_id``; the
        next ``check`` escalates when the rolling window crosses the
        configured suspect/dead thresholds."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._w(replica_id).numeric_faults.append(now)

    def numeric_faults(self, replica_id: str,
                       now: Optional[float] = None) -> int:
        """Guard faults within the rolling window (trims old ones)."""
        now = time.monotonic() if now is None else now
        wnd = self.config.numeric_fault_window_s
        with self._lock:
            w = self._w(replica_id)
            w.numeric_faults = [t for t in w.numeric_faults
                                if now - t < wnd]
            return len(w.numeric_faults)

    def threshold_s(self, replica_id: str) -> float:
        """Current overdue threshold for the replica."""
        with self._lock:
            lat = list(self._w(replica_id).latencies)
        if not lat:
            return self.config.min_threshold_s
        p99 = float(np.percentile(np.asarray(lat), 99))
        return max(self.config.min_threshold_s,
                   self.config.p99_multiplier * p99)

    def _backoff_s_locked(self, w: _ReplicaWatch) -> float:
        b = self.config.backoff_initial_s * (2 ** max(w.trips - 1, 0))
        return min(b, self.config.backoff_max_s)

    def backoff_s(self, replica_id: str) -> float:
        return self._backoff_s_locked(self._w(replica_id))

    def trips(self, replica_id: str) -> int:
        return self._w(replica_id).trips

    def check(self, replica_id: str, busy_for: Optional[float],
              now: Optional[float] = None) -> str:
        """One watchdog evaluation.  ``busy_for`` is how long the
        replica's CURRENT step has been running (None = between steps /
        idle)."""
        now = time.monotonic() if now is None else now
        w = self._w(replica_id)
        # numeric-fault escalation: evaluated first — a
        # replica streaming NaN is damaged whether or not its steps are
        # fast.  DEAD hands its victims to warm failover on healthy
        # survivors; SUSPECT pulls it from routing like an overdue step
        # (same trip/backoff machinery, so re-admission waits out the
        # exponential backoff AND the fault window draining).
        nfaults = self.numeric_faults(replica_id, now)
        if nfaults >= self.config.numeric_fault_dead:
            w.suspect_since = w.suspect_since or now
            return WD_DEAD
        if nfaults >= self.config.numeric_fault_suspect \
                and w.suspect_since is None:
            w.suspect_since = now
            w.trips += 1
            w.backoff_until = None
            return WD_SUSPECT
        if busy_for is not None:
            if not w.latencies:
                # cold replica: the first step includes the compilation,
                # so only the cold-grace ceiling applies — no latency
                # history means no meaningful overdue threshold
                if busy_for >= self.config.cold_grace_s:
                    w.suspect_since = w.suspect_since or now
                    return WD_DEAD
                return WD_OK
            if busy_for >= self.config.hang_timeout_s:
                w.suspect_since = w.suspect_since or now
                return WD_DEAD
            if busy_for >= self.threshold_s(replica_id):
                if w.suspect_since is None:
                    # new incident: trip, arm the (exponential) backoff
                    w.suspect_since = now
                    w.trips += 1
                    w.backoff_until = None
                    return WD_SUSPECT
                return WD_OK
            # mid-step but NOT overdue: a suspect replica whose backoff
            # (armed by a completed step — recovery evidence) elapsed is
            # re-admitted even if it is never sampled idle (a busy
            # replica serving back-to-back steps has only sub-ms idle
            # windows between steps).  Re-admission ALSO requires the
            # numeric-fault window to have drained below the suspect
            # threshold — a replica re-entering routing with its fault
            # count still over the line would be re-suspected one check
            # later, flapping victims in and out of a damaged replica.
            if (w.suspect_since is not None
                    and w.backoff_until is not None
                    and now >= w.backoff_until
                    and nfaults < self.config.numeric_fault_suspect):
                w.suspect_since = None
                w.backoff_until = None
                return WD_READMIT
            return WD_OK
        # not mid-step: a suspect replica has recovered — re-admit only
        # after its backoff (armed at recovery time) elapses AND the
        # numeric-fault window has drained (see above)
        if w.suspect_since is not None:
            if w.backoff_until is None:
                w.backoff_until = now + self.backoff_s(replica_id)
            if now >= w.backoff_until \
                    and nfaults < self.config.numeric_fault_suspect:
                w.suspect_since = None
                w.backoff_until = None
                return WD_READMIT
        return WD_OK


# =============================================================================
# Overload brownout
# =============================================================================
BROWNOUT_NORMAL = 0
BROWNOUT_SHED = 1
BROWNOUT_CLAMP = 2
BROWNOUT_REJECT = 3
BROWNOUT_STAGES = {BROWNOUT_NORMAL: "normal", BROWNOUT_SHED: "shed",
                   BROWNOUT_CLAMP: "clamp", BROWNOUT_REJECT: "reject"}


@dataclass
class BrownoutPolicy:
    """Staged-degradation thresholds over queue PRESSURE (live requests
    / queue_cap, in [0, 1+]).

    Stages (documented order — each stage includes the previous ones):

    1. ``shed``    pressure ≥ ``shed_at``: on each new submission, shed
                   the live not-yet-decoding request with the LOWEST
                   deadline slack (the one least likely to meet its SLO
                   — its tokens would be wasted work) until pressure is
                   back under the threshold.
    2. ``clamp``   pressure ≥ ``clamp_at``: new submissions' budgets are
                   clamped to ``clamp_max_new_tokens`` — everyone gets a
                   shorter answer instead of some getting none.
    3. ``reject``  pressure ≥ ``reject_at``: new submissions are
                   rejected outright (HTTP 503 via UnavailableError).

    Escalation needs ``sustain_evals`` CONSECUTIVE evaluations above the
    stage threshold (a one-SAMPLE spike does not brown the fleet out);
    de-escalation needs the same below ``threshold - release_margin``
    (hysteresis — no flapping at the boundary).  NOTE on units:
    evaluations happen at every submission AND on every replica pump
    poll tick (~``poll_interval_s``), so ``sustain_evals`` alone bounds
    samples, not wall time — a policy that needs pressure sustained for
    a real duration sets ``sustain_s``, which additionally requires the
    streak to SPAN that many seconds before a stage change (0 = count
    alone decides, the default; ``sustain_evals=1`` keeps its immediate
    escalate-at-the-triggering-submission semantics only with
    ``sustain_s=0``).
    """

    shed_at: float = 0.60
    clamp_at: float = 0.80
    reject_at: float = 0.95
    sustain_evals: int = 2
    sustain_s: float = 0.0
    release_margin: float = 0.10
    clamp_max_new_tokens: int = 16

    def target_stage(self, pressure: float) -> int:
        if pressure >= self.reject_at:
            return BROWNOUT_REJECT
        if pressure >= self.clamp_at:
            return BROWNOUT_CLAMP
        if pressure >= self.shed_at:
            return BROWNOUT_SHED
        return BROWNOUT_NORMAL

    def release_stage(self, pressure: float) -> int:
        """Highest stage the pressure still JUSTIFIES under hysteresis
        (thresholds lowered by ``release_margin``)."""
        if pressure >= self.reject_at - self.release_margin:
            return BROWNOUT_REJECT
        if pressure >= self.clamp_at - self.release_margin:
            return BROWNOUT_CLAMP
        if pressure >= self.shed_at - self.release_margin:
            return BROWNOUT_SHED
        return BROWNOUT_NORMAL


class BrownoutController:
    """Sustained-pressure stage machine; exports the current stage as
    the ``serving.brownout_stage`` gauge (0..3).  Pure host logic: call
    ``evaluate(pressure)`` wherever pressure changes (submit, pump
    ticks); the caller acts on the returned stage."""

    def __init__(self, policy: Optional[BrownoutPolicy] = None):
        self.policy = policy or BrownoutPolicy()
        self._stage = BROWNOUT_NORMAL
        self._streak_target: Optional[int] = None
        self._streak_dir = 0            # +1 escalating, -1 releasing
        self._streak = 0
        self._streak_started = 0.0
        stat_registry.get("serving.brownout_stage").set(0)

    @property
    def stage(self) -> int:
        return self._stage

    @property
    def stage_name(self) -> str:
        return BROWNOUT_STAGES[self._stage]

    def evaluate(self, pressure: float,
                 now: Optional[float] = None) -> int:
        """Feed one pressure sample; returns the (possibly new) stage."""
        now = time.monotonic() if now is None else now
        pol = self.policy
        up = pol.target_stage(pressure)
        down = pol.release_stage(pressure)
        if up > self._stage:
            want, direction = up, 1
        elif down < self._stage:
            want, direction = down, -1
        else:
            self._streak_target, self._streak_dir, self._streak = None, 0, 0
            return self._stage
        if direction != self._streak_dir:
            self._streak_target, self._streak_dir = want, direction
            self._streak, self._streak_started = 0, now
        else:
            # same direction, possibly a different stage: converge on
            # the stage EVERY sample in the streak justified — pressure
            # oscillating across a stage boundary (SHED one sample,
            # CLAMP the next) must not reset the sustain clock
            self._streak_target = (min if direction > 0 else max)(
                self._streak_target, want)
        self._streak += 1
        if (self._streak >= max(1, pol.sustain_evals)
                and now - self._streak_started >= pol.sustain_s):
            self._stage = self._streak_target
            self._streak_target, self._streak_dir, self._streak = None, 0, 0
            stat_registry.get("serving.brownout_stage").set(self._stage)
            # fleet-wide black box: a brownout stage change is exactly
            # the "what was happening before X" context a postmortem
            # bundle needs next to the per-request shed/clamp events
            flight.on_transition("brownout.stage",
                                 BROWNOUT_STAGES[self._stage],
                                 f"pressure={pressure:.3f}")
        return self._stage
