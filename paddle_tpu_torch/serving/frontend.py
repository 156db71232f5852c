"""ServingFrontend — the deployable front door over ServingEngine replicas
(the twin of ``paddle_tpu/serving/frontend.py``).

The engine (``engine.py``) ends at ``add_request / step / drain``: the
caller pumps the loop, tokens arrive only at completion, and one engine
is the whole deployment.  This module adds the host orchestration layer
the ROADMAP's "heavy traffic" north star needs:

- ``submit()`` is thread-safe and returns a **ResponseHandle** — a
  per-token streaming iterator with ``cancel()``, ``result()``,
  TTFT/e2e timing and a ``retried`` flag;
- one **pump thread per replica** drives its engine's step loop,
  streams consumed tokens into handles via the engine's
  ``token_callback``, and enforces deadlines/cancellations between
  steps (the engine itself stays single-threaded and threadless);
- a **Router** places each request on the healthy replica with the
  least outstanding tokens, and its deterministic fault-injection hook
  kills a replica mid-decode: the frontend requeues the dead replica's
  live requests onto survivors — with **warm failover** (periodic
  per-request engine snapshots every ``snapshot_interval`` tokens) the
  stream RESUMES from the last checkpoint (``resumed_from`` set, at
  most K tokens recomputed); without a checkpoint it restarts from
  token 0.  Either way ``retried`` flips and the final stream is
  byte-identical to the uninterrupted one (greedy decode is
  deterministic; int8-dynamic KV resumes are exact-within-quantization
  — see docs/SERVING.md "Resilience");
- **admission control**: a bounded live-request cap rejects on
  overload, and per-request deadlines are enforced at submit time, in
  the frontend queue, in the engine queue, and mid-decode (aborted,
  pages freed);
- **watchdog** (opt-in): a monitor thread detects overdue/hung engine
  steps against a rolling-p99 threshold, pulls the replica from the
  routing pool (SUSPECT, exponential backoff before re-admission) and
  declares it dead past the hang timeout — its requests fail over;
- **overload brownout** (opt-in): under sustained queue pressure the
  frontend degrades in stages — shed lowest-deadline-slack queued
  requests, then clamp ``max_new_tokens``, then reject — instead of a
  cliff-edge 429 wall (``serving.brownout_stage`` gauge).

Threading model
---------------
Engines are NOT thread-safe; each is owned by exactly one pump thread.
Cross-thread traffic goes through per-replica inboxes guarded by the
frontend lock, and through ResponseHandle's own condition variable.
``submit()``/``cancel()``/HTTP handlers never touch an engine directly,
and nothing a caller's thread does (submitting, reading a handle's
tokens, ``healthz()``) touches the device.  On the card the replicas
share one device: their engines step side by side and pause while any
one of them captures a CUDA graph (``profiler.jit_cost.capture_gate``).

Device: the replicas run where ``device`` says — the CUDA card by
default (raising without one), the CPU when ``device="cpu"``; the model's
weights must live there.

Terminal statuses — every request reaches exactly one, no hangs:
``completed`` | ``rejected`` | ``cancelled`` | ``deadline_miss`` |
``failed`` (replica died with no healthy survivor, or the request was
invalid for the engine).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import resolve_device
from ..framework.concurrency import OrderedCondition, OrderedRLock
from ..framework.monitor import stat_get
from ..framework.errors import (AlreadyExistsError,
                                DeadlineExceededError, EnforceNotMet,
                                ExecutionTimeoutError, InternalError,
                                InvalidArgumentError, NumericalFaultError,
                                ResourceExhaustedError, UnavailableError)
from ..profiler.flight_recorder import (EV_PLACED, EV_QUEUED,
                                        EV_RESTARTED, EV_RESUMED_ON,
                                        EV_SHIPPED, EV_SNAPSHOT)
from ..profiler.flight_recorder import recorder as flight
from ..profiler.slo import SLOPolicy, SLOTracker
from ..testing.chaos import chaos_site
from .engine import ServingEngine
from .metrics import FleetMetrics, FrontendMetrics, ServingMetrics
from .resilience import (BROWNOUT_CLAMP, BROWNOUT_REJECT, BROWNOUT_SHED,
                         BrownoutController, BrownoutPolicy, EngineSnapshot,
                         Watchdog, WatchdogConfig)
from .router import DEAD, HEALTHY, SUSPECT, Replica, Router

__all__ = ["ResponseHandle", "ServingFrontend", "create_serving_frontend",
           "QUEUED", "RUNNING", "COMPLETED", "REJECTED", "CANCELLED",
           "DEADLINE_MISS", "FAILED", "TERMINAL_STATUSES"]

QUEUED = "queued"
RUNNING = "running"
COMPLETED = "completed"
REJECTED = "rejected"
CANCELLED = "cancelled"
DEADLINE_MISS = "deadline_miss"
FAILED = "failed"
TERMINAL_STATUSES = frozenset(
    {COMPLETED, REJECTED, CANCELLED, DEADLINE_MISS, FAILED})

# default error class per non-completed terminal status — the typed
# taxonomy (framework.errors) every HTTP status code derives from;
# resolvers may override per-outcome (e.g. brownout rejections carry
# UnavailableError → 503 instead of the queue_cap ResourceExhausted 429)
_STATUS_ERROR = {
    REJECTED: ResourceExhaustedError,
    DEADLINE_MISS: DeadlineExceededError,
    FAILED: InternalError,
}


class ResponseHandle:
    """The caller's view of one submitted request (thread-safe).

    Streaming: iterate the handle (or ``events()``) to receive tokens as
    the engine emits them.  After a replica failure the stream RESTARTS
    FROM TOKEN 0 on a surviving replica — ``events()`` yields a
    ``("restart",)`` marker and re-yields from index 0, ``retried``
    flips True, and (greedy decode being deterministic) the restarted
    stream is byte-identical to what the dead replica was producing.
    Blocking: ``result()`` waits for terminal state and returns the full
    token array, raising on any non-completed outcome.
    """

    def __init__(self, request_id: str, max_new_tokens: int,
                 deadline: Optional[float], frontend: "ServingFrontend"):
        self._cond = OrderedCondition("serving.handle")
        self.request_id = request_id
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline          # absolute monotonic or None
        self.submit_time = time.monotonic()
        self.retried = False
        # warm failover: token index the stream resumed from after the
        # last replica failure (None = never resumed from a checkpoint;
        # tokens < resumed_from were decoded by the dead replica and
        # were NOT recomputed)
        self.resumed_from: Optional[int] = None
        self._frontend = frontend
        self._tokens: List[int] = []
        self._status = QUEUED
        self._detail = ""
        self._error_cls: Optional[type] = None
        self._stream_epoch = 0            # bumps on failover restart
        self._resume_pending = False      # events() owes a resume marker
        self._first_token_time: Optional[float] = None
        self._finish_time: Optional[float] = None

    # --- mutators (pump/frontend threads) -----------------------------------
    def _on_token(self, index: int, token: int):
        with self._cond:
            if self._status in TERMINAL_STATUSES:
                return
            if index != len(self._tokens):
                # recompute-preemption replay re-emits earlier indices —
                # the values are identical (deterministic greedy), only
                # forward progress appends
                return
            if self._first_token_time is None:
                self._first_token_time = time.monotonic()
            self._tokens.append(int(token))
            self._status = RUNNING
            self._cond.notify_all()

    def _on_retry(self):
        """Replica failure with NO usable checkpoint: drop the dead
        replica's partial stream and restart from token 0 on a survivor.
        TTFT keeps the FIRST token the client ever saw (the wire truth),
        even though the stream restarts."""
        with self._cond:
            if self._status in TERMINAL_STATUSES:
                return
            self._tokens = []
            self._stream_epoch += 1
            self.retried = True
            self._status = QUEUED
            self._cond.notify_all()

    def _on_resume(self, from_index: int):
        """Replica failure WITH a checkpoint: the stream RESUMES — every
        token already delivered stays valid, the survivor re-decodes
        only the (< snapshot_interval) tokens past index ``from_index``
        and the handle splices them seamlessly (greedy determinism).
        ``events()``/NDJSON surface a ``resume`` marker."""
        with self._cond:
            if self._status in TERMINAL_STATUSES:
                return
            self.retried = True
            self.resumed_from = int(from_index)
            self._resume_pending = True
            self._status = QUEUED
            self._cond.notify_all()

    def _finish(self, status: str, tokens=None, detail: str = "",
                error_cls: Optional[type] = None) -> bool:
        with self._cond:
            if self._status in TERMINAL_STATUSES:
                return False
            if tokens is not None:
                self._tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
            self._status = status
            self._detail = detail
            self._error_cls = error_cls or _STATUS_ERROR.get(status)
            self._finish_time = time.monotonic()
            self._cond.notify_all()
            return True

    # --- inspection ---------------------------------------------------------
    @property
    def status(self) -> str:
        with self._cond:
            return self._status

    @property
    def detail(self) -> str:
        with self._cond:
            return self._detail

    @property
    def error_cls(self) -> Optional[type]:
        """The framework.errors class of a non-completed terminal
        outcome (None while live or on completion) — what the HTTP
        layer derives its status code from."""
        with self._cond:
            return self._error_cls

    @property
    def done(self) -> bool:
        with self._cond:
            return self._status in TERMINAL_STATUSES

    @property
    def tokens(self) -> np.ndarray:
        """Tokens received so far (the full output once completed)."""
        with self._cond:
            return np.asarray(self._tokens, np.int32)

    @property
    def num_tokens(self) -> int:
        with self._cond:
            return len(self._tokens)

    @property
    def ttft_s(self) -> Optional[float]:
        with self._cond:
            if self._first_token_time is None:
                return None
            return self._first_token_time - self.submit_time

    @property
    def ttft_ms(self) -> Optional[float]:
        t = self.ttft_s
        return None if t is None else t * 1e3

    @property
    def e2e_s(self) -> Optional[float]:
        with self._cond:
            if self._finish_time is None:
                return None
            return self._finish_time - self.submit_time

    @property
    def e2e_ms(self) -> Optional[float]:
        t = self.e2e_s
        return None if t is None else t * 1e3

    # --- control ------------------------------------------------------------
    def cancel(self):
        """Request cancellation (idempotent, safe from any thread).  If
        the request already completed, this is a no-op — completion wins
        the race and the handle stays ``completed``."""
        self._frontend._request_cancel(self)

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until terminal; returns the terminal status."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._status in TERMINAL_STATUSES, timeout):
                raise ExecutionTimeoutError(
                    f"request {self.request_id} not terminal after "
                    f"{timeout}s (status {self._status!r})")
            return self._status

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until terminal; returns the generated tokens on
        completion.  Any other outcome raises the outcome's own
        framework.errors class (every one is-a RuntimeError via
        EnforceNotMet, so pre-taxonomy ``except RuntimeError`` callers
        still work)."""
        status = self.wait(timeout)
        if status != COMPLETED:
            # typed: the terminal outcome's taxonomy class (the same
            # one the HTTP layer derives its status from); cancelled
            # carries no error class and raises the taxonomy base
            cls = self.error_cls or EnforceNotMet
            raise cls(
                f"request {self.request_id} {status}"
                + (f": {self.detail}" if self.detail else ""))
        return self.tokens

    # --- streaming ----------------------------------------------------------
    def events(self) -> Iterator[Tuple]:
        """Yield stream events in order:

        ``("token", index, token)``  one generated token
        ``("restart",)``             replica failover without a usable
                                     checkpoint — the stream restarts,
                                     following tokens re-index from 0
                                     (values identical, greedy)
        ``("resume", from_index)``   warm failover — the stream RESUMES:
                                     tokens already yielded stay valid,
                                     decoding continues past
                                     ``from_index`` on a survivor
                                     (live-stream marker; replays of a
                                     finished handle expose it via
                                     ``resumed_from`` instead)
        ``("end", status)``          terminal; always the last event
        """
        epoch = 0
        idx = 0
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._stream_epoch != epoch
                    or self._resume_pending
                    or len(self._tokens) > idx
                    or self._status in TERMINAL_STATUSES)
                restart = self._stream_epoch != epoch
                if restart:
                    epoch = self._stream_epoch
                    idx = 0
                resume_idx = None
                if self._resume_pending:
                    self._resume_pending = False
                    resume_idx = self.resumed_from
                chunk = self._tokens[idx:]
                base = idx
                idx += len(chunk)
                status = self._status
                ended = (status in TERMINAL_STATUSES
                         and self._stream_epoch == epoch
                         and len(self._tokens) == idx)
            if restart:
                yield ("restart",)
            if resume_idx is not None:
                yield ("resume", int(resume_idx))
            for j, tok in enumerate(chunk):
                yield ("token", base + j, int(tok))
            if ended:
                yield ("end", status)
                return

    def __iter__(self) -> Iterator[int]:
        """Token-only view of ``events()``.  NOTE: after a failover the
        stream re-yields from token 0 (check ``retried``); consumers
        that must not double-render should track indices via
        ``events()`` instead."""
        for ev in self.events():
            if ev[0] == "token":
                yield ev[2]


class _Entry:
    """Frontend bookkeeping for one live (non-terminal) request."""

    __slots__ = ("handle", "prompt", "max_new_tokens", "cost", "replica",
                 "in_engine", "cancel_requested", "shed_requested",
                 "snapshot", "snap_tokens", "recover_started",
                 "tokens_at_failover", "use_prefix_cache")

    def __init__(self, handle: ResponseHandle, prompt: np.ndarray,
                 max_new_tokens: int, replica: Replica):
        self.handle = handle
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        # placement score: total tokens this request will hold alive
        self.cost = int(prompt.size) + self.max_new_tokens
        self.replica = replica
        self.in_engine = False
        self.cancel_requested = False
        self.shed_requested = False
        # warm-failover state: the last EngineSnapshot taken for this
        # request (refreshed every snapshot_interval consumed tokens)
        self.snapshot = None
        self.snap_tokens = 0              # generated count at last snapshot
        # failover-recovery timing: set at kill time, cleared when the
        # survivor delivers the first NEW token
        self.recover_started: Optional[float] = None
        self.tokens_at_failover = 0
        # per-request prefix-cache opt-out (submit(prefix_cache=False));
        # rides through failover — the opt-out holds on the survivor too
        self.use_prefix_cache = True


class ServingFrontend:
    """Thread-safe streaming front door over N ServingEngine replicas.

    ``queue_cap`` bounds LIVE requests (queued + running, fleet-wide):
    ``submit`` beyond it returns an already-``rejected`` handle instead
    of queueing unboundedly — the reject-on-overload half of admission
    control; the deadline machinery is the other half.  ``close()``
    drains outstanding work and joins the pump threads.
    """

    def __init__(self, model=None, *, replicas: int = 1,
                 prefill_replicas: int = 0,
                 queue_cap: Optional[int] = 64,
                 default_deadline_ms: Optional[float] = None,
                 engine_kwargs: Optional[dict] = None,
                 engine_factory=None,
                 metrics: Optional[FrontendMetrics] = None,
                 poll_interval_s: float = 0.005,
                 snapshot_interval: Optional[int] = 16,
                 watchdog=None,
                 brownout=None,
                 placement_attempts: int = 4,
                 placement_backoff_s: float = 0.02,
                 snapshot_store=None,
                 prefix_cache: Optional[bool] = None,
                 spec_decode=None,
                 bundle_dir: Optional[str] = None,
                 slo=None,
                 slo_adaptive_brownout: bool = False,
                 device=None):
        """Resilience knobs (docs/SERVING.md "Resilience"):

        - ``snapshot_interval``: checkpoint each in-flight request every
          K consumed tokens so failover resumes from the checkpoint
          instead of token 0 (None disables — failover restarts).
        - ``snapshot_store``: a CheckpointStore (or directory path) that
          additionally PERSISTS each request checkpoint to disk, so a
          frontend RESTART — not just warm in-process failover —
          recovers mid-stream requests via ``recover_pending()``.
          Slots are deleted on client-visible terminal outcomes and
          kept on ``failed`` (the crash-shaped one a new process can
          still rescue).
        - ``watchdog``: True / a WatchdogConfig enables the hung-step
          monitor thread (suspect → backoff → re-admit, dead → failover).
        - ``brownout``: True / a BrownoutPolicy enables staged overload
          degradation (shed lowest-slack → clamp budgets → reject).
        - ``placement_attempts`` / ``placement_backoff_s``: bounded
          retry-with-backoff for transient no-routable-replica
          placement failures (router.pick_with_retry).
        - ``prefix_cache``: opt-in radix prefix cache on every replica
          engine (docs/SERVING.md "Prefix caching") — shared-prefix
          prompts skip straight to the first uncached token.  None
          leaves the engines' own default (off); per-request opt-out
          via ``submit(prefix_cache=False)``.
        - ``spec_decode``: opt-in speculative decoding on every replica
          engine (docs/SERVING.md "Speculative decoding") — an n-gram
          drafter plus one fused K-token verify dispatch per step,
          exact greedy byte-identity preserved; True or an int K-token
          horizon.  None leaves the engines' own default (off).  The
          drafter's per-lane state rides the warm-failover snapshots,
          so a victim resumes speculating on the survivor.
        - ``bundle_dir``: configure the process flight recorder to
          write a postmortem bundle here on every replica death
          (docs/OBSERVABILITY.md "Request tracing & flight recorder");
          None leaves the recorder's current setting (tracing stays on
          either way — only crash-time bundle WRITES need a directory).
        - ``slo``: the fleet SLO engine (
          docs/OBSERVABILITY.md "SLO objectives & burn-rate alerts").
          None/True = the stock ``SLOPolicy.default()`` objectives
          (availability, deadline, NaN-quarantine error budgets + a p95
          TTFT latency target); an ``SLOPolicy`` customizes the
          objectives; an ``SLOTracker`` is used as-is (tests inject a
          fake clock this way); False disables —
          ``healthz()["slo"]`` is then None.  Evaluation rides the pump
          ticks (throttled by the tracker's own clock) and every
          ``healthz()`` call; alerts land in the flight recorder and in
          crash postmortem bundles.
        - ``slo_adaptive_brownout``: opt-in (default OFF — byte-
          identity suites untouched): a FIRING burn-rate alert raises
          the BrownoutController's pressure floor (shed stage; clamp at
          2× the page threshold), so the fleet degrades before the
          queue alone would force it.  Requires both ``slo`` and
          ``brownout`` enabled.
        - ``prefill_replicas``: disaggregated prefill/decode fleet
          (docs/SERVING.md "Tiered KV & disaggregation"):
          this many ADDITIONAL replicas (ids ``prefill-<i>``) carry the
          "prefill" role — fresh submissions place there, and once a
          request has its first token its filled KV pages SHIP to a
          "decode"-role replica inside an EngineSnapshot (the failover
          transport), so decode ITL stops paying for other requests'
          prefill bursts.  ``replicas`` then counts the decode pool.
          0 (default) keeps the colocated fleet (every replica role
          "any") byte-identically.
        - ``device``: where the replica engines run — None is the CUDA
          card (raises without one), ``"cpu"`` the plain PyTorch path.
          The model must live there; a custom ``engine_factory`` builds
          its engines on the same device.
        """
        self.device = resolve_device(device)
        if model is None and engine_factory is None:
            raise InvalidArgumentError(
                "pass a model or an engine_factory")
        if engine_factory is not None and engine_kwargs:
            raise InvalidArgumentError(
                "engine_kwargs and engine_factory are mutually "
                "exclusive — the factory owns engine construction, so "
                "the kwargs would be silently ignored")
        if prefix_cache is not None and not isinstance(prefix_cache, bool):
            # same discipline as watchdog=/brownout=: a truthy config
            # object must not silently become the default
            raise InvalidArgumentError(
                f"prefix_cache must be None or a bool, "
                f"got {prefix_cache!r}")
        if engine_factory is not None and prefix_cache is not None:
            raise InvalidArgumentError(
                "prefix_cache is an engine knob — a custom "
                "engine_factory owns engine construction, so pass "
                "ServingEngine(prefix_cache=...) inside the factory")
        if spec_decode is not None and not isinstance(spec_decode,
                                                     (bool, int)):
            # same discipline as prefix_cache=: a truthy config object
            # must not silently become the default (the engine
            # re-validates the int-horizon form)
            raise InvalidArgumentError(
                f"spec_decode must be None, a bool, or an int K-token "
                f"horizon, got {spec_decode!r}")
        if engine_factory is not None and spec_decode is not None:
            raise InvalidArgumentError(
                "spec_decode is an engine knob — a custom "
                "engine_factory owns engine construction, so pass "
                "ServingEngine(spec_decode=...) inside the factory")
        if replicas < 1:
            raise InvalidArgumentError("replicas must be >= 1")
        if not isinstance(prefill_replicas, int) \
                or isinstance(prefill_replicas, bool) \
                or prefill_replicas < 0:
            raise InvalidArgumentError(
                f"prefill_replicas must be an int >= 0, "
                f"got {prefill_replicas!r}")
        self._disagg = prefill_replicas > 0
        self.metrics = metrics or FrontendMetrics()
        # ONE ServingMetrics across replicas: the process-global
        # serving.* registry names hold fleet aggregates instead of N
        # engines resetting each other.  The frontend OWNS engine
        # metrics: engines built by a custom engine_factory get their
        # .metrics replaced with this shared instance too, so
        # stats()["engines"] is always the fleet aggregate.
        self.engine_metrics = ServingMetrics()
        user_factory = engine_factory
        if user_factory is None:
            ekw = dict(engine_kwargs or {})
            ekw.setdefault("metrics", self.engine_metrics)
            ekw.setdefault("device", self.device)
            if prefix_cache is not None:
                ekw["prefix_cache"] = prefix_cache
            if spec_decode is not None:
                ekw["spec_decode"] = spec_decode

            def engine_factory():
                return ServingEngine(model, **ekw)
        else:
            def engine_factory():
                eng = user_factory()
                if eng.device != self.device:
                    raise InvalidArgumentError(
                        f"engine_factory built an engine on {eng.device} "
                        f"but the frontend runs on {self.device} — pass "
                        "the same device to both")
                eng.metrics = self.engine_metrics
                return eng

        self.router = Router(metrics=self.engine_metrics)
        self.queue_cap = None if queue_cap is None else int(queue_cap)
        self.default_deadline_ms = default_deadline_ms
        self._poll_interval = float(poll_interval_s)
        self.snapshot_interval = (None if snapshot_interval is None
                                  else max(1, int(snapshot_interval)))
        self._snapshot_store = None
        if snapshot_store is not None:
            if self.snapshot_interval is None:
                # disk persistence rides on the periodic warm-failover
                # checkpoints: with the interval disabled nothing would
                # ever be written and recover_pending() after a crash
                # would silently find an empty store — refuse loudly
                # (the knob-validation discipline: a truthy config must
                # not silently do nothing)
                raise InvalidArgumentError(
                    "snapshot_store requires snapshot_interval (disk "
                    "persistence piggybacks on the periodic request "
                    "checkpoints; with snapshot_interval=None no slot "
                    "would ever be written)")
            from ..io.checkpoint import CheckpointStore

            self._snapshot_store = (
                snapshot_store if isinstance(snapshot_store, CheckpointStore)
                else CheckpointStore(snapshot_store))
        self._persist_errors = 0
        self._placement_attempts = max(1, int(placement_attempts))
        self._placement_backoff = float(placement_backoff_s)
        # watchdog: False/None = off; True = defaults; or a config.
        # Anything else truthy raises — silently swapping an operator's
        # dict of thresholds for the defaults would leave them believing
        # tighter SLOs are active
        self.watchdog: Optional[Watchdog] = None
        if watchdog:
            if watchdog is not True and not isinstance(watchdog,
                                                       WatchdogConfig):
                raise InvalidArgumentError(
                    "watchdog must be True or a "
                    f"WatchdogConfig, got {watchdog!r}")
            self.watchdog = Watchdog(
                watchdog if isinstance(watchdog, WatchdogConfig) else None)
        # brownout: False/None = off; True = defaults; or a policy
        self.brownout: Optional[BrownoutController] = None
        if brownout:
            if brownout is not True and not isinstance(brownout,
                                                       BrownoutPolicy):
                raise InvalidArgumentError(
                    "brownout must be True or a "
                    f"BrownoutPolicy, got {brownout!r}")
            self.brownout = BrownoutController(
                brownout if isinstance(brownout, BrownoutPolicy) else None)
        # SLO engine: None/True = stock policy; a policy or
        # a ready tracker customizes; False = off.  Same discipline as
        # watchdog=/brownout=: an unrecognized truthy config must not
        # silently become the default objectives
        self.slo: Optional[SLOTracker] = None
        if slo is None or slo is True:
            self.slo = SLOTracker()
        elif slo is False:
            self.slo = None
        elif isinstance(slo, SLOTracker):
            self.slo = slo
        elif isinstance(slo, SLOPolicy):
            self.slo = SLOTracker(slo)
        else:
            raise InvalidArgumentError(
                "slo must be None/True (stock objectives), False "
                "(off), an SLOPolicy, or an SLOTracker — "
                f"got {slo!r}")
        if not isinstance(slo_adaptive_brownout, bool):
            raise InvalidArgumentError(
                f"slo_adaptive_brownout must be a bool, "
                f"got {slo_adaptive_brownout!r}")
        if slo_adaptive_brownout and (self.slo is None
                                      or self.brownout is None):
            # a knob that silently does nothing is a misconfigured SLO
            # an operator believes is active
            raise InvalidArgumentError(
                "slo_adaptive_brownout=True requires both slo= and "
                "brownout= enabled")
        self._slo_adaptive = slo_adaptive_brownout
        # fleet rollup: {replica, role} labeled gauges
        # re-derived on every healthz()/stats() read
        self.fleet = FleetMetrics(self.router)
        self._lock = OrderedRLock("serving.frontend")
        self._live: Dict[str, _Entry] = {}
        self._closing = False
        self._rid = itertools.count()
        self._replicas: List[Replica] = []
        # disaggregation: when a prefill pool exists the
        # ``replica-*`` fleet becomes the DECODE pool and ``prefill-*``
        # replicas fill pages and ship them over; with no prefill pool
        # every replica stays role "any" (colocated, byte-identical to
        # the pre-disaggregation fleet)
        decode_role = "decode" if self._disagg else "any"
        for i in range(int(replicas)):
            rep = Replica(f"replica-{i}", engine_factory(),
                          role=decode_role)
            # engine emits per-token; bind the replica so tokens from a
            # replica the request has been failed away from are dropped
            rep.engine.token_callback = (
                lambda rid, idx, tok, rep=rep:
                self._emit(rep, rid, idx, tok))
            # chaos "engine.step" faults count per replica, not per
            # whoever's pump thread raced first
            rep.engine.chaos_key = rep.id
            self.router.add(rep)
            self._replicas.append(rep)
        for i in range(int(prefill_replicas)):
            rep = Replica(f"prefill-{i}", engine_factory(),
                          role="prefill")
            rep.engine.token_callback = (
                lambda rid, idx, tok, rep=rep:
                self._emit(rep, rid, idx, tok))
            rep.engine.chaos_key = rep.id
            self.router.add(rep)
            self._replicas.append(rep)
        for rep in self._replicas:
            t = threading.Thread(target=self._pump, args=(rep,),
                                 name=f"serving-pump-{rep.id}", daemon=True)
            rep.thread = t
            t.start()
        # flight recorder: request traces are always on; a
        # bundle_dir arms crash-time postmortem writes, and the context
        # provider hands the dump per-replica engine stats + health.
        # The arming is UNDONE at close() (restoring the prior value)
        # so a later fleet in the same process doesn't keep dumping
        # into this one's — possibly deleted — directory.
        self._armed_bundle_dir = None
        self._prev_bundle_dir = None
        if bundle_dir is not None:
            self._prev_bundle_dir = flight.bundle_dir
            flight.configure(bundle_dir=bundle_dir)
            self._armed_bundle_dir = bundle_dir
        self._recorder_ctx = f"serving.frontend-{id(self):x}"
        flight.register_context(self._recorder_ctx,
                                self._postmortem_context)
        self._monitor_thread = None
        if self.watchdog is not None:
            self._monitor_thread = threading.Thread(
                target=self._monitor, name="serving-watchdog", daemon=True)
            self._monitor_thread.start()

    # --- submission ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               deadline_ms: Optional[float] = None, stream: bool = True,
               request_id: Optional[str] = None,
               prefix_cache: bool = True) -> ResponseHandle:
        """Submit one generation request; returns immediately with a
        ResponseHandle (possibly already terminal: ``rejected`` on
        overload / no healthy replica, ``deadline_miss`` on an
        already-expired deadline).  Raises ValueError only for requests
        that could never run (empty prompt, budget beyond the engine's
        ``max_seq_len``).  ``stream`` is advisory — tokens are always
        delivered to the handle; it exists so callers (the HTTP layer)
        can record the client's intent.  ``prefix_cache=False`` opts
        THIS request out of the fleet's prefix cache (no lookup, and its
        pages are never sealed for other requests) — a no-op when the
        engines run without one."""
        del stream  # tokens always stream into the handle
        if not isinstance(prefix_cache, bool):
            raise InvalidArgumentError(
                f"prefix_cache must be a bool, got {prefix_cache!r}")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = (None if deadline_ms is None
                    else time.monotonic() + float(deadline_ms) / 1e3)
        # brownout: evaluate queue pressure at every submission; stage 2+
        # clamps the budget BEFORE validation/handle creation (the
        # degraded service the caller actually gets), stage 3 rejects in
        # the admission block below
        stage = 0
        if self.brownout is not None:
            with self._lock:
                stage = self.brownout.evaluate(
                    self._brownout_pressure_locked())
            if stage >= BROWNOUT_CLAMP:
                cap = self.brownout.policy.clamp_max_new_tokens
                if max_new_tokens > cap:
                    max_new_tokens = cap
                    self.metrics.on_brownout_clamp()
        with self._lock:
            probe = next((r.engine for r in self._replicas
                          if r.state != DEAD), None)
        if probe is not None:
            prompt = probe.check_request(prompt, max_new_tokens)
        else:
            prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = request_id or f"fr-{next(self._rid)}"
        handle = ResponseHandle(rid, max_new_tokens, deadline, self)
        cost = int(prompt.size) + int(max_new_tokens)
        with self._lock:
            if rid in self._live:
                raise AlreadyExistsError(
                    f"request_id {rid!r} is already live")
            # counted only once the request is accepted as a real
            # submission (raises above don't inflate the counter), but
            # BEFORE the terminal-at-submit outcomes — so submitted ==
            # completed+rejects+cancels+deadline_miss+failures holds
            self.metrics.on_submit()
            # trace id assigned at submit: every accepted submission
            # gets a timeline, terminal-at-submit outcomes included
            flight.start_trace(rid).event(
                EV_QUEUED, prompt_tokens=int(prompt.size),
                max_new_tokens=int(max_new_tokens),
                deadline_ms=deadline_ms)
            if self._closing:
                return self._reject_locked(handle, "frontend is closing")
            if stage >= BROWNOUT_REJECT:
                self.metrics.on_brownout_reject()
                return self._reject_locked(
                    handle, "brownout stage 3: sustained overload — "
                    "retry later", error_cls=UnavailableError)
            if (self.queue_cap is not None
                    and len(self._live) >= self.queue_cap):
                return self._reject_locked(
                    handle,
                    f"queue_cap {self.queue_cap} live requests reached")
            if deadline is not None and time.monotonic() >= deadline:
                handle._finish(DEADLINE_MISS,
                               detail="deadline expired at submit")
                self.metrics.on_deadline_miss()
                flight.request_terminal(rid, DEADLINE_MISS,
                                        detail="deadline expired at "
                                               "submit")
                return handle
            # disaggregated fleets place fresh submissions on the
            # prefill pool; shipping moves them to decode later
            place_role = "prefill" if self._disagg else None
            rep = self.router.pick(cost=cost, role=place_role)
            if rep is not None:
                self._place_locked(handle, prompt, max_new_tokens, rep,
                                   use_prefix_cache=prefix_cache)
                if stage >= BROWNOUT_SHED:
                    self._shed_lowest_slack_locked(
                        exclude=handle.request_id)
                return handle
            retryable = any(r.state in (HEALTHY, SUSPECT)
                            for r in self._replicas)
            if not retryable or self._placement_attempts <= 1:
                # same taxonomy as the post-backoff rejection below: no
                # healthy replica is Unavailable (503), not overload
                return self._reject_locked(handle, "no healthy replica",
                                           error_cls=UnavailableError)
        # transient no-routable-replica (e.g. every replica SUSPECT
        # while a watchdog backoff elapses): bounded retry-with-backoff
        # OUTSIDE the frontend lock — other submissions/pumps proceed
        rep = self.router.pick_with_retry(
            cost=cost, attempts=self._placement_attempts,
            backoff_s=self._placement_backoff, deadline=deadline,
            role=place_role)
        with self._lock:
            if self._closing:
                return self._reject_locked(handle, "frontend is closing")
            if rep is not None and rep.state == DEAD:
                # the pick happened outside our lock: the replica may
                # have died (and had its inbox cleared + victims
                # collected) before we re-acquired it — placing there
                # would strand the entry forever.  One locked re-pick
                # closes the window.
                rep = self.router.pick(cost=cost, role=place_role)
            if rep is None:
                return self._reject_locked(
                    handle, "no healthy replica (after bounded "
                    "retry-with-backoff)", error_cls=UnavailableError)
            if rid in self._live:
                # an explicit request_id raced another live submission
                # while the lock was dropped; rejecting (not raising)
                # keeps submitted == sum(terminal statuses)
                return self._reject_locked(
                    handle, f"request_id {rid!r} is already live")
            if (self.queue_cap is not None
                    and len(self._live) >= self.queue_cap):
                # other submissions may have filled the cap while this
                # one slept in the backoff — re-check so the live-set
                # bound (and the pressure signal built on it) holds
                return self._reject_locked(
                    handle,
                    f"queue_cap {self.queue_cap} live requests reached")
            self._place_locked(handle, prompt, max_new_tokens, rep,
                               use_prefix_cache=prefix_cache)
            if stage >= BROWNOUT_SHED:
                self._shed_lowest_slack_locked(exclude=handle.request_id)
        return handle

    def _place_locked(self, handle: ResponseHandle, prompt: np.ndarray,
                      max_new_tokens: int, rep: Replica,
                      use_prefix_cache: bool = True):
        entry = _Entry(handle, prompt, max_new_tokens, rep)
        entry.use_prefix_cache = use_prefix_cache
        self._live[handle.request_id] = entry
        self.router.charge(rep, entry.cost)
        rep.inbox.append(entry)
        rep.wake.set()
        self._update_depth_gauges_locked()
        flight.request_event(handle.request_id, EV_PLACED,
                             replica=rep.id)

    def _pressure_locked(self) -> float:
        """Queue pressure in [0, 1]: live requests over queue_cap (an
        uncapped frontend reports 0 — brownout needs a capacity notion)."""
        if self.queue_cap is None or self.queue_cap <= 0:
            return 0.0
        return len(self._live) / float(self.queue_cap)

    def _brownout_pressure_locked(self) -> float:
        """Pressure fed to the brownout controller.  Normally queue
        pressure; with ``slo_adaptive_brownout=True`` a firing SLO
        alert imposes a pressure FLOOR (shed_at while burning, clamp_at
        once the burn is runaway) so the fleet starts load-shedding on
        budget burn even before the queue itself backs up."""
        p = self._pressure_locked()
        if self._slo_adaptive and self.slo is not None:
            p = max(p, self.slo.brownout_pressure_floor(
                self.brownout.policy))
        return p

    def _shed_lowest_slack_locked(self, exclude: Optional[str] = None):
        """Brownout stage 1+: shed the live not-yet-decoding request
        with the LOWEST deadline slack (deadline - now; no deadline =
        infinite slack) — the request least likely to meet its SLO, so
        its tokens would be wasted work.  One shed per triggering
        submission; deterministic tie-break by request id.  ``exclude``
        shields the triggering arrival itself: shedding targets the
        BACKLOG (an arrival the backlog can't absorb is handled by the
        clamp/reject stages, not by admitting-then-shedding it)."""
        now = time.monotonic()
        cands = [e for e in self._live.values()
                 if e.handle.num_tokens == 0 and not e.cancel_requested
                 and not e.shed_requested
                 and e.handle.request_id != exclude]
        if not cands:
            return

        def slack(e):
            d = e.handle.deadline
            return (float("inf") if d is None else d - now,
                    e.handle.request_id)

        victim = min(cands, key=slack)
        self.metrics.on_brownout_shed()
        rep = victim.replica
        if not victim.in_engine and victim in rep.inbox:
            rep.inbox.remove(victim)
            victim.shed_requested = True
            # resolve outside the inbox but inside our lock scope is
            # fine — _resolve re-enters the RLock
            self._resolve(victim, REJECTED,
                          "brownout shed (lowest deadline slack)",
                          error_cls=UnavailableError)
        else:
            victim.shed_requested = True
            rep.sheds.append(victim)
            rep.wake.set()

    def _reject_locked(self, handle: ResponseHandle, detail: str,
                       error_cls: Optional[type] = None) -> ResponseHandle:
        handle._finish(REJECTED, detail=detail, error_cls=error_cls)
        self.metrics.on_reject()
        flight.request_terminal(handle.request_id, REJECTED,
                                detail=detail)
        return handle

    # --- cancellation -------------------------------------------------------
    def _request_cancel(self, handle: ResponseHandle):
        immediate = None
        with self._lock:
            entry = self._live.get(handle.request_id)
            if (entry is None or entry.handle is not handle
                    or entry.cancel_requested):
                return
            entry.cancel_requested = True
            rep = entry.replica
            if not entry.in_engine and entry in rep.inbox:
                rep.inbox.remove(entry)
                immediate = entry
            else:
                rep.cancels.append(entry)
            rep.wake.set()
        if immediate is not None:
            self._resolve(immediate, CANCELLED)

    # --- restart recovery ----------------------------------------
    def recover_pending(self) -> List[ResponseHandle]:
        """Re-admit every request the PREVIOUS process persisted to the
        snapshot store and never finished: each ``req-*`` slot becomes a
        live mid-stream request on this frontend — tokens up to the
        checkpoint are pre-filled on the handle (never re-decoded),
        decoding continues on a replica via the engine's snapshot
        restore path, and the handle carries ``retried=True`` /
        ``resumed_from`` plus a ``("resume", n)`` stream marker exactly
        like a warm failover.  Deadlines were persisted as REMAINING
        budget and re-anchor to this process's clock.

        Corrupt slots are skipped (``snapshot_store.last_skipped``); a
        slot with no routable replica finishes ``failed`` and KEEPS its
        slot for the next attempt.  Returns the recovered handles.
        """
        store = self._snapshot_store
        if store is None:
            raise InvalidArgumentError(
                "recover_pending() needs ServingFrontend("
                "snapshot_store=...)")
        handles: List[ResponseHandle] = []
        for name in store.named():
            if not name.startswith("req-"):
                continue
            loaded = store.load_named(name, return_numpy=True)
            if loaded is None:
                continue        # corrupt — recorded in store.last_skipped
            state, _manifest = loaded
            try:
                snap = EngineSnapshot.from_state(state)
            except EnforceNotMet:
                continue        # incompatible schema — leave for tooling
            rid = snap.request_id
            handle = ResponseHandle(rid, snap.max_new_tokens,
                                    snap.deadline, self)
            n = snap.num_generated
            with handle._cond:
                # everything up to the checkpoint was already decoded
                # (and possibly streamed) by the dead process — pre-fill
                # so result() returns the FULL sequence and the engine's
                # callbacks (which fire from index n) append seamlessly
                handle._tokens = [int(t) for t in snap.generated]
                handle.retried = True
                handle.resumed_from = n
                handle._resume_pending = True
            with self._lock:
                if self._closing or rid in self._live:
                    continue
                self.metrics.on_submit()
                flight.start_trace(rid).event(
                    EV_QUEUED, prompt_tokens=int(snap.prompt.size),
                    max_new_tokens=int(snap.max_new_tokens),
                    recovered_from_disk=True)
                if (handle.deadline is not None
                        and time.monotonic() >= handle.deadline):
                    handle._finish(DEADLINE_MISS,
                                   detail="deadline expired before "
                                          "restart recovery")
                    self.metrics.on_deadline_miss()
                    flight.request_terminal(
                        rid, DEADLINE_MISS,
                        detail="deadline expired before restart "
                               "recovery")
                    handles.append(handle)
                    continue
                rep = self.router.pick(
                    cost=int(snap.prompt.size) + int(snap.max_new_tokens))
                if rep is None:
                    # keep the slot: failed is the crash-shaped terminal
                    handle._finish(FAILED,
                                   detail="no healthy replica for "
                                          "restart recovery",
                                   error_cls=UnavailableError)
                    self.metrics.on_failure()
                    flight.request_terminal(
                        rid, FAILED, detail="no healthy replica for "
                                            "restart recovery")
                    handles.append(handle)
                    continue
                entry = _Entry(handle, snap.prompt, snap.max_new_tokens,
                               rep)
                entry.snapshot = snap
                entry.snap_tokens = n
                self._live[rid] = entry
                self.router.charge(rep, entry.cost)
                rep.inbox.append(entry)
                rep.wake.set()
                self._update_depth_gauges_locked()
                flight.request_event(rid, EV_RESUMED_ON, replica=rep.id,
                                     from_token=n,
                                     recovered_from_disk=True)
            self.metrics.on_recovered()
            handles.append(handle)
        # the deadline-missed slots above are client-visible terminals —
        # retire them (outside the lock; _resolve never saw them)
        for h in handles:
            if h.status == DEADLINE_MISS:
                try:
                    store.delete_named(f"req-{h.request_id}")
                except Exception:  # noqa: BLE001 — stale slot only
                    pass
        return handles

    # --- fault injection / lifecycle ---------------------------------------
    def inject_failure(self, replica_id: str, at_step: int):
        """Arm the router's deterministic kill switch (see
        Router.inject_failure): the replica crashes once its engine-step
        counter reaches ``at_step``; its live requests fail over."""
        self.router.inject_failure(replica_id, at_step)

    def drain_replica(self, replica_id: str):
        """Graceful drain: no new placements; in-flight work finishes."""
        self.router.set_draining(replica_id)
        self.router.get(replica_id).wake.set()

    def health(self) -> dict:
        hz = self.router.healthz()
        with self._lock:
            hz["inflight"] = len(self._live)
            hz["queued"] = sum(1 for e in self._live.values()
                               if not e.in_engine)
            hz["closing"] = self._closing
        hz["status"] = ("ok" if hz["healthy_replicas"] > 0 and
                        not hz["closing"] else "unhealthy")
        hz["brownout_stage"] = (0 if self.brownout is None
                                else self.brownout.stage)
        return hz

    def healthz(self) -> dict:
        """``health()`` plus the ops surface: refreshes the per-replica
        fleet gauges (``serving.fleet.*``) and, when SLO tracking is on,
        appends per-objective ``{attainment, budget_remaining,
        burn_rate, alert}`` plus the recent alert log under ``"slo"``
        (``None`` when tracking is disabled).  This is what the HTTP
        ``/healthz`` endpoint and ``tools/dash.py`` serve."""
        hz = self.health()
        self.fleet.refresh()
        if self.slo is None:
            hz["slo"] = None
        else:
            hz["slo"] = {
                "objectives": self.slo.evaluate(),
                "active_alerts": self.slo.active_alerts(),
                "alert_log": self.slo.alert_log(),
            }
        hz["window"] = {
            "frontend": self.metrics.snapshot().get("window", {}),
            "engine": self.engine_metrics.snapshot().get("window", {}),
        }
        hz["tiers"] = {
            "kv_pages_in_use": stat_get("serving.kv_pages_in_use"),
            "prefix_cached_tokens": stat_get("serving.prefix.cached_tokens"),
            "host_pages": stat_get("serving.prefix.host_pages"),
            "disk_pages": stat_get("serving.prefix.disk_pages"),
        }
        return hz

    def trace(self, request_id: str) -> Optional[dict]:
        """Structured lifecycle timeline of a live or recently-terminal
        request (queued → placed → admitted → ... → terminal, replicas
        annotated), or None when unknown.  Export it with
        ``profiler.export_request_trace`` or fetch it over HTTP at
        ``GET /debug/requests/<rid>``."""
        return flight.trace(request_id)

    def recent_traces(self) -> List[dict]:
        """Summaries of recently-terminal request traces (newest last)
        — the ``GET /debug/requests`` listing."""
        return flight.recent_traces()

    def _postmortem_context(self) -> dict:
        """Dump-time context for postmortem bundles: per-replica health
        + engine stats.  Runs on whichever thread triggered the dump
        while pump threads may still be stepping — engine stats are
        host-side reads, a racing mutation at worst skews a count in a
        diagnostic artifact (and a raising provider degrades to an
        error string in the bundle, never blocks the dump)."""
        out = {"replicas": {}, "health": self.health()}
        for rep in self._replicas:
            out["replicas"][rep.id] = {
                "state": rep.state,
                "steps": rep.steps,
                "dead_reason": rep.dead_reason or None,
                "engine": rep.engine.stats(),
            }
        if self.slo is not None:
            # active alerts + objective states ride into every crash
            # bundle — the first postmortem question is "were we
            # burning budget when it died?"
            out["slo"] = self.slo.context()
        return out

    def stats(self) -> dict:
        """Frontend + fleet-aggregate engine metrics + router health."""
        return {
            "frontend": self.metrics.snapshot(),
            "engines": self.engine_metrics.snapshot(),
            "router": self.router.healthz(),
            "recorder": flight.snapshot(),
            "resilience": {
                "snapshot_interval": self.snapshot_interval,
                "watchdog_enabled": self.watchdog is not None,
                "brownout_enabled": self.brownout is not None,
                "brownout_stage": (None if self.brownout is None
                                   else self.brownout.stage),
                "snapshot_store": (None if self._snapshot_store is None
                                   else self._snapshot_store.directory),
                "snapshot_persist_errors": self._persist_errors,
                "disaggregated": self._disagg,
            },
            "slo": (None if self.slo is None else self.slo.status()),
        }

    def close(self, timeout: float = 30.0):
        """Drain outstanding work, stop the pump threads, and fail any
        request that could not finish (e.g. every replica dead)."""
        with self._lock:
            self._closing = True
            reps = list(self._replicas)
            for rep in reps:
                rep.wake.set()
        for rep in reps:
            if rep.thread is not None:
                rep.thread.join(timeout)
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout)
        with self._lock:
            leftovers = list(self._live.values())
        for entry in leftovers:
            self._resolve(entry, FAILED, detail="frontend closed")
        flight.unregister_context(self._recorder_ctx)
        if (self._armed_bundle_dir is not None
                and flight.bundle_dir == self._armed_bundle_dir):
            # restore only if nobody re-armed it since (last-set wins)
            flight.bundle_dir = self._prev_bundle_dir

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- internals (pump threads) ------------------------------------------
    def _emit(self, rep: Replica, rid: str, idx: int, tok: int):
        with self._lock:
            entry = self._live.get(rid)
            if entry is None or entry.replica is not rep:
                return
            handle = entry.handle
            if (entry.recover_started is not None
                    and idx >= entry.tokens_at_failover):
                # first NEW token since the kill: the survivor has
                # caught up past everything the client already had
                self.engine_metrics.on_failover_recovery(
                    time.monotonic() - entry.recover_started)
                entry.recover_started = None
        handle._on_token(idx, tok)

    def _entry_for(self, rep: Replica, rid: str) -> Optional[_Entry]:
        with self._lock:
            entry = self._live.get(rid)
            if entry is not None and entry.replica is rep:
                return entry
            return None

    def _update_depth_gauges_locked(self):
        self.metrics.set_inflight(len(self._live))
        self.metrics.set_queue_depth(
            sum(1 for e in self._live.values() if not e.in_engine))

    def _resolve(self, entry: _Entry, status: str, detail: str = "",
                 tokens=None, error_cls: Optional[type] = None) -> bool:
        """Move one live request to a terminal state exactly once."""
        rid = entry.handle.request_id
        with self._lock:
            if self._live.get(rid) is not entry:
                return False                 # someone else resolved it
            del self._live[rid]
            self.router.discharge(entry.replica, entry.cost)
            self._update_depth_gauges_locked()
        finished = entry.handle._finish(status, tokens=tokens,
                                        detail=detail, error_cls=error_cls)
        if finished and self._snapshot_store is not None \
                and status != FAILED:
            # the persisted slot is only useful for crash recovery:
            # client-visible terminals retire it; FAILED (every replica
            # dead / frontend closed) keeps it so a NEW process's
            # recover_pending() can still rescue the stream from disk
            try:
                self._snapshot_store.delete_named(f"req-{rid}")
            except Exception:  # noqa: BLE001 — stale slot, not a failure
                pass
        if finished:
            h = entry.handle
            if status == COMPLETED:
                self.metrics.on_complete(h.ttft_s, h.e2e_s)
            elif status == CANCELLED:
                self.metrics.on_cancel()
            elif status == DEADLINE_MISS:
                self.metrics.on_deadline_miss()
            elif status == REJECTED:
                self.metrics.on_reject()
            elif status == FAILED:
                self.metrics.on_failure()
            # first-wins with the engine's completed-at-retire record
            # (same status); every other outcome is frontend-owned
            flight.request_terminal(rid, status, detail=detail,
                                    tokens=h.num_tokens,
                                    retried=h.retried)
        return finished

    def _pump(self, rep: Replica):
        """One replica's drive loop (the ONLY thread touching its
        engine): intake (add or snapshot-restore) → cancellations →
        brownout sheds → one engine step (crash-contained, watchdog-
        probed) → harvest expiries/completions → periodic snapshots →
        chaos / failure-injection checks."""
        eng = rep.engine
        while True:
            with self._lock:
                closing = self._closing
                work, rep.inbox = rep.inbox, []
                cancels, rep.cancels = rep.cancels, []
                sheds, rep.sheds = rep.sheds, []
                if self.brownout is not None:
                    # pressure falls as requests finish — keep the stage
                    # tracking reality between submissions too
                    self.brownout.evaluate(
                        self._brownout_pressure_locked())
            if self.slo is not None:
                # outside the frontend lock: the tracker has its own
                # (lower-ranked) lock and only reads counter registries
                self.slo.maybe_evaluate()
            if rep.state == DEAD:
                break
            now = time.monotonic()
            for entry in work:
                h = entry.handle
                if entry.cancel_requested:
                    self._resolve(entry, CANCELLED)
                    continue
                if h.deadline is not None and now >= h.deadline:
                    self._resolve(entry, DEADLINE_MISS,
                                  "expired in frontend queue")
                    continue
                try:
                    if entry.snapshot is not None:
                        # warm failover: resume mid-stream from the
                        # checkpoint.  The deadline is the handle's
                        # ABSOLUTE submit-time SLO — a requeue after
                        # replica death must never extend it
                        entry.snapshot.deadline = h.deadline
                        eng.restore(entry.snapshot)
                    else:
                        eng.add_request(
                            entry.prompt, entry.max_new_tokens,
                            request_id=h.request_id,
                            deadline=h.deadline,
                            prefix_cache=entry.use_prefix_cache)
                    with self._lock:
                        entry.in_engine = True
                except ValueError as e:
                    # a fresh request failing validation is the caller's
                    # fault (400); a snapshot failing to restore is an
                    # internal failover/configuration fault (500) — the
                    # client's original request was valid
                    self._resolve(entry, FAILED, str(e),
                                  error_cls=(InternalError
                                             if entry.snapshot is not None
                                             else InvalidArgumentError))
            for entry in cancels:
                if eng.abort(entry.handle.request_id):
                    self._resolve(entry, CANCELLED)
                # else: it finished first — the outputs harvest owns it
            for entry in sheds:
                if eng.abort(entry.handle.request_id):
                    self._resolve(entry, REJECTED,
                                  "brownout shed (lowest deadline slack)",
                                  error_cls=UnavailableError)
                # else: it finished first — the outputs harvest owns it
            if eng.scheduler.has_work() or eng._pending:
                rep.step_started = time.monotonic()
                try:
                    eng.step()
                except Exception as e:  # noqa: BLE001 — crash containment
                    # an engine-step exception is a replica crash: the
                    # engine's device state is suspect, so the replica
                    # is retired and its requests fail over (resuming
                    # from their snapshots where one exists)
                    rep.step_started = None
                    self._kill(rep, f"engine step raised "
                                    f"{type(e).__name__}: {e}")
                    break
                t_done = time.monotonic()
                step_s = t_done - rep.step_started
                rep.step_started = None
                rep.steps += 1
                rep.last_step_time = t_done
                if self.watchdog is not None:
                    self.watchdog.observe_step(rep.id, step_s)
                self._harvest(rep, eng)
                self._maybe_snapshot(rep, eng)
                if rep.role == "prefill":
                    self._ship_ready(rep, eng)
                # snapshot/ship calls SYNC a pipelined engine: a request
                # whose final token was still in flight at the harvest
                # above retires during that sync, and with no work left
                # the pump would idle with its output stranded — sweep
                # again so the iteration that retires also resolves
                self._harvest(rep, eng)
                fault = chaos_site("replica.kill", key=rep.id)
                if fault is not None and fault.action == "kill":
                    self._kill(rep, f"chaos kill at step {rep.steps}")
                    break
                if (rep.fail_at_step is not None
                        and rep.steps >= rep.fail_at_step):
                    self._kill(rep,
                               f"injected failure at step {rep.steps}")
                    break
            elif closing:
                break
            else:
                rep.wake.wait(self._poll_interval)
                rep.wake.clear()

    def _maybe_snapshot(self, rep: Replica, eng: ServingEngine):
        """Checkpoint every request on ``rep`` that consumed
        ``snapshot_interval`` tokens since its last snapshot — the warm
        failover freshness bound (≤ K tokens ever need recomputing)."""
        if self.snapshot_interval is None:
            return
        k = self.snapshot_interval
        with self._lock:
            due = [e for e in self._live.values()
                   if e.replica is rep and e.in_engine
                   and not e.cancel_requested and not e.shed_requested
                   and e.handle.num_tokens - e.snap_tokens >= k]
        for entry in due:
            snap = eng.snapshot(entry.handle.request_id)
            if snap is None:
                continue          # finished/preempted meanwhile — keep old
            updated = False
            with self._lock:
                if (self._live.get(entry.handle.request_id) is entry
                        and entry.replica is rep):
                    entry.snapshot = snap
                    entry.snap_tokens = snap.num_generated
                    updated = True
            if updated:
                flight.request_event(entry.handle.request_id,
                                     EV_SNAPSHOT, replica=rep.id,
                                     tokens=snap.num_generated)
            if updated and self._snapshot_store is not None:
                # disk durability rides on the warm-failover checkpoint
                # (pump thread, outside the frontend lock).  Best-effort:
                # a persist failure never fails the live stream — the
                # in-memory snapshot still drives warm failover; the
                # error count is surfaced in stats()["resilience"]
                rid = entry.handle.request_id
                try:
                    self._snapshot_store.save_named(
                        f"req-{rid}", snap.to_state(),
                        metadata={"request_id": rid})
                except Exception:  # noqa: BLE001 — durability degraded,
                    with self._lock:  # stream unaffected
                        self._persist_errors += 1

    def _ship_ready(self, rep: Replica, eng: ServingEngine):
        """Disaggregation hand-off: move every request on a
        PREFILL replica that has produced its first token over to the
        decode pool.  The transport vehicle is the warm-failover
        ``EngineSnapshot`` — pages come off the device through the same
        CRC-free but exactly-once snapshot/abort/restore path failover
        already trusts, so a prefill death mid-ship is indistinguishable
        from any other replica death (the snapshot re-routes, nothing is
        half-shipped).  Runs on the prefill replica's pump thread right
        after its step: snapshot + abort happen with no step in between,
        so the snapshot is exactly the live stream (``num_generated ==
        handle.num_tokens``) and the decode replica's re-emission splices
        seamlessly through ``_on_token``'s forward-progress filter.

        Per-request chaos site ``kv.ship`` (deny → the request simply
        stays and decodes where it is — colocated fallback, never an
        error).  No decode capacity → same fallback.
        """
        with self._lock:
            ready = [e for e in self._live.values()
                     if e.replica is rep and e.in_engine
                     and not e.cancel_requested and not e.shed_requested
                     and e.handle.num_tokens >= 1]
        for entry in ready:
            rid = entry.handle.request_id
            fault = chaos_site("kv.ship", key=rid)
            if fault is not None and fault.action == "deny":
                continue          # colocated fallback: decode in place
            t0 = time.perf_counter()
            snap = eng.snapshot(rid)
            if snap is None:
                continue          # finished/preempted meanwhile
            target = self.router.pick(cost=entry.cost, exclude=rep,
                                      role="decode")
            if target is None:
                continue          # no decode capacity — decode in place
            if not eng.abort(rid):
                continue          # completed first — harvest owns it
            pages = (int(snap.pages["k"][0].shape[0])
                     if snap.pages.get("k") else 0)
            self.engine_metrics.on_ship(
                pages, time.perf_counter() - t0)
            moved = False
            with self._lock:
                if (self._live.get(rid) is entry
                        and entry.replica is rep):
                    entry.snapshot = snap
                    entry.snap_tokens = snap.num_generated
                    self.router.discharge(rep, entry.cost)
                    self.router.charge(target, entry.cost)
                    entry.replica = target
                    entry.in_engine = False
                    target.inbox.append(entry)
                    target.wake.set()
                    self._update_depth_gauges_locked()
                    moved = True
            if moved:
                flight.request_event(rid, EV_SHIPPED, replica=target.id,
                                     from_replica=rep.id, pages=pages)

    def _harvest(self, rep: Replica, eng: ServingEngine):
        for rid in eng.take_expired():
            entry = self._entry_for(rep, rid)
            if entry is not None:
                self._resolve(entry, DEADLINE_MISS, "deadline expired")
        for rid in eng.take_faulted():
            # numeric quarantine: exactly the damaged
            # request fails, typed 500 — and the watchdog hears about
            # it: repeated guard faults on one replica are damaged
            # hardware/state, not damaged requests, and escalate
            # suspect → dead so victims move to healthy survivors
            entry = self._entry_for(rep, rid)
            if entry is not None:
                self._resolve(
                    entry, FAILED,
                    "numeric guard quarantined the request "
                    "(non-finite logits)",
                    error_cls=NumericalFaultError)
            if self.watchdog is not None:
                self.watchdog.note_numeric_fault(rep.id)
        for rid in list(eng.outputs.keys()):
            toks = eng.take_output(rid)
            entry = self._entry_for(rep, rid)
            if entry is not None:
                self._resolve(entry, COMPLETED, tokens=toks)

    def _kill(self, rep: Replica, reason: str):
        """Replica crash (injected, chaos, engine-step exception, or
        watchdog hang): mark it dead and fail its live requests over to
        survivors.  A request with a checkpoint RESUMES mid-stream from
        it (``resumed_from`` set, ≤ snapshot_interval tokens recomputed);
        without one the stream restarts from token 0.  Placement uses
        bounded retry-with-backoff (a transient all-SUSPECT fleet is not
        a terminal failure); with no survivor at all the request
        terminates ``failed``."""
        with self._lock:
            # exactly-once: the watchdog declaring a hung replica dead
            # can race the pump's own crash path (the hung step finally
            # returning into a chaos/injection check) — a second kill
            # would double-requeue the same victims
            if rep.kill_claimed:
                return
            rep.kill_claimed = True
        self.router.mark_dead(rep, reason)
        with self._lock:
            victims = [e for e in self._live.values()
                       if e.replica is rep]
            rep.inbox.clear()
            rep.cancels.clear()
            rep.sheds.clear()
        now = time.monotonic()
        for entry in victims:
            h = entry.handle
            if entry.cancel_requested:
                self._resolve(entry, CANCELLED,
                              "cancelled during failover")
                continue
            if entry.shed_requested:
                # a brownout shed pending in the dead replica's sheds
                # list was already counted — honor it here instead of
                # silently failing the request over (which would keep
                # it running, uncheckpointed, despite the accounting)
                self._resolve(entry, REJECTED,
                              "brownout shed (lowest deadline slack)",
                              error_cls=UnavailableError)
                continue
            if h.deadline is not None and now >= h.deadline:
                self._resolve(entry, DEADLINE_MISS,
                              "expired during failover")
                continue
            target = self.router.pick_with_retry(
                cost=entry.cost, attempts=self._placement_attempts,
                backoff_s=self._placement_backoff, deadline=h.deadline)
            if target is None:
                self._resolve(
                    entry, FAILED,
                    f"replica {rep.id} died ({reason}); no healthy "
                    "survivor to retry on", error_cls=UnavailableError)
                continue
            snap = entry.snapshot
            with self._lock:
                entry.tokens_at_failover = h.num_tokens
                entry.recover_started = time.monotonic()
            if snap is not None:
                h._on_resume(snap.num_generated)
                # tokens before the checkpoint are NOT re-decoded — the
                # warm-failover win vs a token-0 restart
                self.metrics.on_recompute_saved(snap.num_generated)
                flight.request_event(h.request_id, EV_RESUMED_ON,
                                     replica=target.id,
                                     from_token=snap.num_generated,
                                     dead_replica=rep.id)
            else:
                h._on_retry()
                flight.request_event(h.request_id, EV_RESTARTED,
                                     replica=target.id,
                                     dead_replica=rep.id)
            self.metrics.on_retry()
            with self._lock:
                self.router.discharge(rep, entry.cost)
                entry.replica = target
                entry.in_engine = False
                # cancel_requested is NOT reset: a cancel that raced the
                # failover is honored by the target's intake loop
                self.router.charge(target, entry.cost)
                target.inbox.append(entry)
                target.wake.set()
                self._update_depth_gauges_locked()
        # black box: replica death is THE postmortem trigger — after the
        # victims are requeued (their resumed_on/restarted events are in
        # the rings) write the bundle, if a bundle_dir is armed.  Never
        # raises; the failover above already succeeded either way.
        flight.auto_dump(f"replica {rep.id} died: {reason}")

    def _monitor(self):
        """Watchdog thread: scan replicas for overdue/hung engine steps
        (suspect → pulled from routing; hung → dead + failover;
        recovered → re-admitted after exponential backoff)."""
        wd = self.watchdog
        interval = wd.config.check_interval_s
        while True:
            with self._lock:
                if self._closing:
                    return
            now = time.monotonic()
            for rep in list(self._replicas):
                if rep.state == DEAD:
                    continue
                try:
                    verdict = wd.check(rep.id, rep.busy_for(now), now)
                    if verdict == "suspect":
                        if self.router.mark_suspect(rep):
                            self.engine_metrics.on_watchdog_trip()
                    elif verdict == "dead":
                        # requeue OFF the monitor thread: _kill blocks
                        # in pick_with_retry, and this thread is the
                        # only one that can READMIT the suspect
                        # survivors that retry may be waiting for
                        threading.Thread(
                            target=self._kill,
                            args=(rep, "watchdog: engine step hung "
                                  f"beyond {wd.config.hang_timeout_s}s"),
                            name=f"serving-failover-{rep.id}",
                            daemon=True).start()
                    elif verdict == "readmit":
                        self.router.mark_healthy(rep)
                except Exception:  # noqa: BLE001 — the watchdog must
                    # never die silently: a crashed monitor would turn
                    # every future hang into an unbounded stall
                    pass
            time.sleep(interval)


def create_serving_frontend(model, config=None, **overrides
                            ) -> ServingFrontend:
    """Build a ServingFrontend from an ``inference.Config`` on which
    ``enable_serving(...)`` was called: engine knobs come from
    ``serving_config()`` (its card becomes the frontend's ``device``),
    frontend knobs (``replicas``, ``queue_cap``, ``snapshot_interval``,
    ...) from ``frontend_config()``; keyword arguments override either
    side (unknown keys go to the engines).  Passing ``engine_factory``
    together with engine knobs raises — a custom factory owns engine
    construction outright."""
    fe_kwargs: dict = {}
    engine_kwargs: dict = {}
    if config is not None:
        if not getattr(config, "serving_enabled", lambda: False)():
            raise InvalidArgumentError(
                "config has serving disabled — call "
                "Config.enable_serving(...) first")
        engine_kwargs.update(config.serving_config())
        fe_kwargs.update(config.frontend_config())
        # the frontend places its replica engines on its own device
        fe_kwargs["device"] = engine_kwargs.pop("device", None)
    engine_kwargs.update(overrides.pop("engine_kwargs", {}))
    for key in ("replicas", "prefill_replicas", "queue_cap",
                "default_deadline_ms", "engine_factory", "metrics",
                "poll_interval_s", "snapshot_interval", "watchdog",
                "brownout", "placement_attempts", "placement_backoff_s",
                "snapshot_store", "prefix_cache", "spec_decode",
                "bundle_dir", "slo", "slo_adaptive_brownout", "device"):
        if key in overrides:
            fe_kwargs[key] = overrides.pop(key)
    engine_kwargs.update(overrides)
    return ServingFrontend(model, engine_kwargs=engine_kwargs, **fe_kwargs)
