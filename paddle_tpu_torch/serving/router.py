"""Multi-replica router: placement, health, and fault injection — the
twin of ``paddle_tpu/serving/router.py``.

One ``Replica`` wraps one ``ServingEngine`` plus the queueing state its
pump thread drains (the thread itself lives in ``frontend.py`` — the
router is pure bookkeeping, so it can be unit-tested without spinning up
engines or threads).  The ``Router`` owns the placement policy:

placement      least-outstanding-tokens — a new request goes to the
               HEALTHY replica with the smallest sum of admitted-but-
               unfinished work (prompt + budget tokens), ties broken by
               replica id, so routing is deterministic given the
               submission order.  ``pick_with_retry`` adds BOUNDED
               retry-with-backoff for transient no-routable-replica
               conditions (every replica momentarily SUSPECT) instead
               of failing the request on first error.
roles          two-stage scheduling (disaggregated prefill/
               decode): each replica carries a ROLE — ``"prefill"``
               (fills pages, ships them), ``"decode"`` (receives
               shipped pages, streams tokens) or ``"any"`` (colocated,
               the default).  ``pick(role=...)`` places within the
               matching pool ("any" replicas belong to every pool);
               when a pool has no healthy member the pick FALLS BACK to
               the full healthy set — a dead prefill fleet degrades to
               colocated serving, never to an outage.  Each pool's
               health is independently visible in ``healthz()``, so
               the existing watchdog/brownout machinery (and an
               autoscaler reading it) reasons per pool.
health         a replica is routable only in the HEALTHY state.
               SUSPECT replicas (watchdog: overdue/hung step) take
               nothing new until the watchdog re-admits them after an
               exponential backoff; DRAINING replicas finish their
               in-flight work but take nothing new; DEAD replicas are
               never routed to again.
fault
injection      ``inject_failure(replica_id, at_step)`` arms a
               deterministic kill switch: the pump thread compares the
               replica's engine-step counter against ``at_step`` after
               every step and simulates a crash mid-decode when it
               trips (the chaos framework's ``replica.kill`` site
               generalizes this to seeded fault schedules —
               paddle_tpu_torch.testing.chaos).  The frontend then requeues
               the dead replica's live requests onto survivors,
               resuming from their last checkpoint when one exists
               (token-0 restart otherwise) — the failover path is
               exercised by tests/bench, not just described.

Thread-safety: every mutator/reader takes the router's RLock.  The
frontend also serializes its own bookkeeping with its own lock; lock
order is always frontend → router, never the reverse.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..framework.concurrency import OrderedRLock
from ..framework.errors import AlreadyExistsError, NotFoundError
from ..profiler.flight_recorder import recorder as flight

__all__ = ["Replica", "Router", "HEALTHY", "SUSPECT", "DRAINING", "DEAD"]

HEALTHY = "healthy"
SUSPECT = "suspect"
DRAINING = "draining"
DEAD = "dead"


class Replica:
    """One serving engine + the routing/queueing state around it.

    ``inbox`` holds work items the pump thread has not yet handed to the
    engine and ``cancels`` holds cancellation requests; BOTH are guarded
    by the frontend's lock (the router never touches them).  ``wake`` is
    set whenever new work or a cancel arrives so an idle pump thread
    reacts immediately instead of on its poll timeout.
    """

    def __init__(self, replica_id: str, engine, role: str = "any",
                 mesh_size: Optional[int] = None):
        if role not in ("any", "prefill", "decode"):
            from ..framework.errors import InvalidArgumentError

            raise InvalidArgumentError(
                f"replica role must be 'any', 'prefill' or 'decode', "
                f"got {role!r}")
        self.id = str(replica_id)
        self.engine = engine
        # disaggregation pool membership: "any" serves both
        # pools (the colocated default)
        self.role = role
        # mesh-sharded serving: chips backing this replica —
        # an N-chip tp/sp replica decodes at ~N× aggregate bandwidth,
        # so placement normalizes outstanding work by it.  Defaults to
        # the engine's own mesh size (1 for single-chip engines and for
        # the bare test doubles that carry no mesh attribute).
        if mesh_size is None:
            layout = getattr(engine, "_mesh_layout", None)
            mesh_size = 1 if layout is None else int(layout.size)
        if int(mesh_size) < 1:
            from ..framework.errors import InvalidArgumentError

            raise InvalidArgumentError(
                f"replica mesh_size must be >= 1, got {mesh_size}")
        self.mesh_size = int(mesh_size)
        self.state = HEALTHY
        self.dead_reason = ""
        self.inbox: List = []                # guarded by the frontend lock
        self.cancels: List = []              # guarded by the frontend lock
        self.sheds: List = []                # guarded by the frontend lock
        self.wake = threading.Event()
        self.thread: Optional[threading.Thread] = None
        # engine steps taken by the pump thread — the fault-injection
        # clock (deterministic given a deterministic drive)
        self.steps = 0
        # set (under the frontend lock) by the first _kill to claim this
        # replica — the watchdog's dead verdict can race the pump's own
        # crash path, and the victims must be requeued exactly once
        self.kill_claimed = False
        self.fail_at_step: Optional[int] = None
        self.last_step_time: Optional[float] = None
        # watchdog probe: set by the pump thread immediately before
        # entering engine.step(), cleared right after — a non-None value
        # means the replica is mid-step and ``now - step_started`` is
        # how long it has been stuck there
        self.step_started: Optional[float] = None
        # admitted-but-unfinished work in tokens (prompt + budget) —
        # the placement score
        self.outstanding_tokens = 0

    def busy_for(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds the replica's CURRENT engine step has been running
        (None when between steps) — the watchdog's overdue signal."""
        started = self.step_started
        if started is None:
            return None
        return (time.monotonic() if now is None else now) - started

    @property
    def healthy(self) -> bool:
        return self.state == HEALTHY

    def status(self) -> dict:
        return {
            "id": self.id,
            "role": self.role,
            "mesh_size": self.mesh_size,
            "state": self.state,
            "dead_reason": self.dead_reason or None,
            "steps": self.steps,
            "outstanding_tokens": self.outstanding_tokens,
            "inbox_depth": len(self.inbox),
            "last_step_age_s": (
                None if self.last_step_time is None
                else round(time.monotonic() - self.last_step_time, 3)),
            "busy_for_s": (
                None if self.step_started is None
                else round(time.monotonic() - self.step_started, 3)),
        }


class Router:
    """Least-outstanding-tokens placement over a set of replicas.

    ``metrics`` (an optional ServingMetrics) receives
    ``on_retry_backoff`` events from ``pick_with_retry`` — the frontend
    wires its fleet-shared instance in."""

    def __init__(self, metrics=None):
        self._lock = OrderedRLock("serving.router")
        self.replicas: List[Replica] = []
        self.metrics = metrics

    # --- membership ---------------------------------------------------------
    def add(self, replica: Replica):
        with self._lock:
            if any(r.id == replica.id for r in self.replicas):
                raise AlreadyExistsError(
                    f"duplicate replica id {replica.id!r}")
            self.replicas.append(replica)

    def get(self, replica_id: str) -> Replica:
        with self._lock:
            for r in self.replicas:
                if r.id == replica_id:
                    return r
        raise NotFoundError(f"unknown replica {replica_id!r}")

    # --- placement ----------------------------------------------------------
    def pick(self, cost: int = 0,
             exclude: Optional[Replica] = None,
             role: Optional[str] = None) -> Optional[Replica]:
        """The healthy replica with the least outstanding work (tokens),
        ties broken by id; None when no healthy replica exists.  ``cost``
        is accepted for symmetry with charge() but does not affect the
        choice.  ``role`` restricts the pick to that pool ("any"
        replicas belong to every pool); an empty pool falls back to ALL
        healthy replicas — disaggregation degrades to colocation, never
        to an outage.

        Mesh normalization: the score is outstanding tokens
        PER CHIP (``outstanding_tokens / mesh_size``) — an N-chip mesh
        replica decodes at ~N× the single-chip rate, so equal raw
        backlogs mean the mesh replica finishes sooner; without the
        divide a mixed fleet would starve its biggest replicas."""
        with self._lock:
            cands = [r for r in self.replicas
                     if r.state == HEALTHY and r is not exclude]
            if role is not None:
                pool = [r for r in cands if r.role in (role, "any")]
                if pool:
                    cands = pool
            if not cands:
                return None
            return min(cands, key=lambda r: (
                r.outstanding_tokens / r.mesh_size, r.id))

    def pick_with_retry(self, cost: int = 0,
                        exclude: Optional[Replica] = None,
                        attempts: int = 4, backoff_s: float = 0.02,
                        deadline: Optional[float] = None,
                        role: Optional[str] = None
                        ) -> Optional[Replica]:
        """``pick`` with bounded retry-with-backoff for TRANSIENT
        placement failures: when no replica is routable right now (all
        SUSPECT while a watchdog backoff elapses, a kill racing a
        re-admission), sleep through an exponential backoff and try
        again instead of failing the request on first error.  Gives up
        after ``attempts`` tries, when every replica is terminally DEAD,
        or when the next backoff would overrun ``deadline`` (absolute
        monotonic).  Each slept retry counts into
        ``serving.retries_backoff``."""
        delay = float(backoff_s)
        for i in range(max(1, int(attempts))):
            rep = self.pick(cost=cost, exclude=exclude, role=role)
            if rep is not None:
                return rep
            with self._lock:
                # nothing to wait FOR: no replica can ever come back
                recoverable = any(r.state in (HEALTHY, SUSPECT)
                                  and r is not exclude
                                  for r in self.replicas)
            if not recoverable or i + 1 >= max(1, int(attempts)):
                return None
            if deadline is not None \
                    and time.monotonic() + delay >= deadline:
                return None
            time.sleep(delay)
            delay *= 2.0
            if self.metrics is not None:
                self.metrics.on_retry_backoff()
        return None

    def charge(self, replica: Replica, tokens: int):
        with self._lock:
            replica.outstanding_tokens += int(tokens)

    def discharge(self, replica: Replica, tokens: int):
        with self._lock:
            replica.outstanding_tokens = max(
                0, replica.outstanding_tokens - int(tokens))

    # --- health / lifecycle -------------------------------------------------
    def healthy_replicas(self) -> List[Replica]:
        with self._lock:
            return [r for r in self.replicas if r.state == HEALTHY]

    def inject_failure(self, replica_id: str, at_step: int):
        """Arm the deterministic kill switch: the replica dies (crash
        simulation) once its engine-step counter reaches ``at_step``.
        ``at_step`` is an ABSOLUTE step count of that replica; arming it
        at or below the current count kills on the next step."""
        with self._lock:
            self.get(replica_id).fail_at_step = int(at_step)

    def set_draining(self, replica_id: str):
        """Graceful drain: stop routing new work to the replica; its
        in-flight requests run to completion."""
        changed = False
        with self._lock:
            rep = self.get(replica_id)
            if rep.state in (HEALTHY, SUSPECT):
                rep.state = DRAINING
                changed = True
        if changed:
            flight.on_transition("replica.draining", replica_id)

    def mark_suspect(self, replica: Replica) -> bool:
        """Watchdog: pull an overdue replica from the routing pool (its
        in-flight work continues — a straggler, not a corpse).  Returns
        True when the state actually changed."""
        with self._lock:
            changed = replica.state == HEALTHY
            if changed:
                replica.state = SUSPECT
        if changed:
            flight.on_transition("replica.suspect", replica.id,
                                 "watchdog: overdue engine step")
        return changed

    def mark_healthy(self, replica: Replica) -> bool:
        """Watchdog re-admission after backoff: SUSPECT → HEALTHY."""
        with self._lock:
            changed = replica.state == SUSPECT
            if changed:
                replica.state = HEALTHY
        if changed:
            flight.on_transition("replica.healthy", replica.id,
                                 "watchdog: re-admitted after backoff")
        return changed

    def mark_dead(self, replica: Replica, reason: str = ""):
        with self._lock:
            replica.state = DEAD
            replica.dead_reason = reason
        flight.on_transition("replica.dead", replica.id, reason)

    def healthz(self) -> dict:
        """Health summary (the /healthz payload's router section)."""
        with self._lock:
            reps = [r.status() for r in self.replicas]
            healthy = sum(1 for r in self.replicas if r.state == HEALTHY)
            suspect = sum(1 for r in self.replicas if r.state == SUSPECT)
            # per-pool health: "any" replicas back both
            # pools, so each count answers "can this STAGE make
            # progress" — what an autoscaler scales on
            pools = {
                stage: sum(1 for r in self.replicas
                           if r.state == HEALTHY
                           and r.role in (stage, "any"))
                for stage in ("prefill", "decode")}
            # chip accounting: replicas are the routing
            # unit, chips the capacity unit — an autoscaler sizing a
            # mixed fleet needs both
            chips = sum(r.mesh_size for r in self.replicas)
            healthy_chips = sum(r.mesh_size for r in self.replicas
                                if r.state == HEALTHY)
        return {
            "healthy_replicas": healthy,
            "suspect_replicas": suspect,
            "total_replicas": len(reps),
            "total_chips": chips,
            "healthy_chips": healthy_chips,
            "healthy_by_role": pools,
            "replicas": reps,
        }
