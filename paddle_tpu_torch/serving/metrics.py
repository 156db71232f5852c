"""Serving observability — the twin of ``paddle_tpu/serving/metrics.py``.

Every engine step publishes gauges/counters into
``framework.monitor.stat_registry`` under the ``serving.*`` namespace,
plus LATENCY HISTOGRAMS (log-bucketed, p50/p95/p99 in ``snapshot()`` and
in the Prometheus exposition) for step, prefill, decode and TTFT, and
recent-window twins of them (the last minute) that the SLO engine and
``/healthz`` read.  ``FrontendMetrics`` counts the front door's
submissions and terminal outcomes (``serving.frontend.*``) and
``FleetMetrics`` rolls the router's per-replica state into labeled
gauges (``serving.fleet.*``).

Aggregates answer "how is the fleet doing"; the REQUEST-SCOPED view
("what happened to request X") lives in the flight recorder
(``profiler.flight_recorder``).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from ..framework.concurrency import OrderedLock
from ..framework.monitor import stat_registry

__all__ = ["ServingMetrics", "FrontendMetrics", "FleetMetrics"]

# recent-window geometry for the serving WindowedHistograms:
# six 10s slices give "the last minute" at 10s resolution — coarse
# enough to stay O(1) memory, fine enough that a decode regression is
# visible within one scrape interval
_WINDOW_S = 60.0
_WINDOW_SLICES = 6


class ServingMetrics:
    """Aggregates per-step serving stats; ints mirror into StatRegistry,
    latency samples into its histograms.

    The ``serving.*`` registry names are PROCESS-GLOBAL (Prometheus
    semantics): engines in one process share them, and constructing a
    new ServingMetrics resets them.  Run one engine per process (the
    deployment shape) or pass each engine a metrics object only at
    points where a shared reset is acceptable — the ServingFrontend
    passes ONE instance to all its replica engines, so the registry
    holds fleet-wide aggregates.  Every method is THREAD-SAFE: the
    registry primitives carry their own locks and the derived-rate
    accumulators here are guarded by ``_lock`` (replica pump threads
    call ``on_step`` concurrently)."""

    GAUGES = ("serving.queue_depth", "serving.running_seqs",
              "serving.kv_pages_in_use", "serving.batch_bucket",
              "serving.kv_cache_bytes", "serving.batch_occupancy",
              "serving.snapshot_bytes", "serving.brownout_stage",
              # prefix cache: tokens' worth of KV the radix
              # index can currently serve (resident sealed pages)
              "serving.prefix.cached_tokens",
              # tiered KV: page payloads currently held by
              # the host-RAM and disk tiers (demoted, promotable)
              "serving.prefix.host_pages", "serving.prefix.disk_pages",
              # speculative decoding: lifetime fraction of
              # drafted tokens the verifier accepted
              "serving.spec.accept_rate",
              # unified ragged dispatch: per-lane query-row
              # bucket (Q) of the most recent ragged step — 1 in steady
              # decode, the chunk bucket while prefill rows ride along
              "serving.ragged.row_bucket",
              # mesh-sharded serving: the engine's mesh shape
              # — tensor-parallel head shards, sequence-parallel page
              # shards, and their product (chips per replica)
              "serving.shard.tp", "serving.shard.sp",
              "serving.shard.devices")
    COUNTERS = ("serving.steps", "serving.tokens_generated",
                "serving.requests_admitted", "serving.requests_completed",
                "serving.preemptions", "serving.prefill_chunks",
                "serving.prefill_tokens", "serving.aborts",
                "serving.deadline_miss", "serving.snapshots",
                "serving.restores", "serving.watchdog_trips",
                "serving.retries_backoff",
                # prefix cache: per-admission hit/miss, the
                # prefill tokens the hits skipped, LRU page evictions,
                # and copy-on-write page copies on divergence
                "serving.prefix.hits", "serving.prefix.misses",
                "serving.prefix.hit_tokens", "serving.prefix.evictions",
                "serving.prefix.cow",
                # tiered KV: evicted payloads captured into
                # the host tier instead of discarded, and tier hits
                # restored to device pages (each one a re-prefill the
                # H2D copy replaced)
                "serving.prefix.demotions", "serving.prefix.promotions",
                # disaggregation: KV pages shipped prefill →
                # decode inside EngineSnapshots
                "serving.disagg.shipped_pages",
                # speculative decoding: drafted tokens
                # submitted to the verifier, the split into accepted
                # (emitted for ~1/K of the bandwidth) vs rejected, and
                # the lanes rolled back mid-draft
                "serving.spec.drafted", "serving.spec.accepted",
                "serving.spec.rejected", "serving.spec.rollbacks",
                # numeric guards: lanes whose decode/verify
                # logits came back non-finite, and the requests
                # quarantined (failed with NumericalFaultError, lane
                # reset, pages scrubbed + freed) as a result
                "serving.guard.nan_lanes", "serving.guard.quarantines",
                # unified ragged dispatch: mixed-batch
                # dispatches and the per-kind query rows they carried —
                # decode rows (one per advancing lane), prefill-chunk
                # rows (prompt positions riding beside decode instead of
                # blocking it) and spec-verify rows (K teacher-forced
                # positions per speculating lane)
                "serving.ragged.steps", "serving.ragged.decode_rows",
                "serving.ragged.prefill_rows", "serving.ragged.spec_rows",
                # mesh-sharded serving: ragged dispatches that
                # ran as one mesh program (every step crosses the
                # tp/sp collectives), and maintenance traffic that had to
                # assemble (gather) or re-distribute (scatter) sharded
                # KV pages through the host — snapshots, tier demotions,
                # scrubs and restores
                "serving.shard.steps", "serving.shard.page_gathers",
                "serving.shard.page_scatters")
    HISTOGRAMS = ("serving.step_latency_ms", "serving.prefill_latency_ms",
                  "serving.decode_latency_ms", "serving.ttft_ms",
                  "serving.dispatch_gap_ms",
                  "serving.failover_recovery_ms",
                  # disaggregation: one prefill→decode ship,
                  # snapshot-gather through re-admission on the decode
                  # replica
                  "serving.disagg.transfer_ms")
    # recent-window twins: same samples as the cumulative
    # histograms above, but over the last _WINDOW_S seconds only —
    # "is decode degrading RIGHT NOW", the feed for the SLO engine's
    # latency view and the ops dashboard
    WINDOWED = ("serving.window.ttft_ms", "serving.window.itl_ms",
                "serving.window.decode_latency_ms")

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        """``clock``: injectable monotonic clock (default
        ``time.monotonic``) — drives window rotation and the derived
        elapsed/rate accounting, so tests replay deterministic time."""
        self._lock = OrderedLock("serving.metrics")
        self._clock = clock if clock is not None else time.monotonic
        self.reset()

    def reset(self):
        with self._lock:
            self._start: Optional[float] = None
            self._steps = 0
            self._tokens = 0
            self._occupancy_sum = 0.0
            self._occupancy_count = 0
            self._ttft_sum = 0.0
            self._ttft_count = 0
            self._completed = 0
            self._prefill_tokens = 0
            self._prefill_seconds = 0.0
        for name in self.GAUGES + self.COUNTERS:
            stat_registry.get(name).reset()
        for name in self.HISTOGRAMS:
            stat_registry.histogram(name).reset()
        for name in self.WINDOWED:
            # re-bind the registry-cached window to THIS instance's
            # clock (a fresh fleet with a fake clock must not inherit a
            # previous fleet's)
            stat_registry.windowed(
                name, _WINDOW_S, _WINDOW_SLICES).configure(
                window_s=_WINDOW_S, slices=_WINDOW_SLICES,
                clock=self._clock)

    # --- event hooks (called by the engine) --------------------------------
    def on_admission(self, n: int):
        if n:
            stat_registry.get("serving.requests_admitted").add(n)

    def on_first_token(self, arrival_time: float, now: float):
        ttft = now - arrival_time
        with self._lock:
            self._ttft_sum += ttft
            self._ttft_count += 1
        stat_registry.histogram("serving.ttft_ms").observe(ttft * 1e3)
        stat_registry.windowed("serving.window.ttft_ms").observe(
            ttft * 1e3, now=now)

    def on_completion(self, n: int = 1):
        with self._lock:
            self._completed += n
        stat_registry.get("serving.requests_completed").add(n)

    def on_preemption(self, n: int = 1):
        stat_registry.get("serving.preemptions").add(n)

    def on_abort(self, n: int = 1):
        """A queued or in-flight sequence was retired without output
        (client cancel, replica failure cleanup, or deadline abort)."""
        stat_registry.get("serving.aborts").add(n)

    def on_deadline_miss(self, n: int = 1):
        """A request's deadline passed while queued (dropped before
        admission) or mid-decode (aborted, pages freed)."""
        stat_registry.get("serving.deadline_miss").add(n)

    # --- resilience hooks (docs/SERVING.md "Resilience") -------------------
    def on_snapshot(self, nbytes: int):
        """One request checkpoint taken; the gauge tracks the latest
        snapshot's size (tokens + KV pages, host bytes)."""
        stat_registry.get("serving.snapshots").add(1)
        stat_registry.get("serving.snapshot_bytes").set(int(nbytes))

    def on_restore(self, n: int = 1):
        """A snapshot was re-admitted mid-stream (warm failover)."""
        stat_registry.get("serving.restores").add(n)

    def on_watchdog_trip(self, n: int = 1):
        """The watchdog pulled a replica from the routing pool
        (overdue/hung engine step)."""
        stat_registry.get("serving.watchdog_trips").add(n)

    def on_retry_backoff(self, n: int = 1):
        """One placement retry slept through its backoff (transient
        no-routable-replica condition)."""
        stat_registry.get("serving.retries_backoff").add(n)

    def on_failover_recovery(self, seconds: float):
        """Replica death → first token decoded by the survivor (the
        warm-failover headline)."""
        stat_registry.histogram("serving.failover_recovery_ms").observe(
            seconds * 1e3)

    # --- prefix cache hooks (docs/SERVING.md "Prefix caching") -------------
    def on_prefix_hit(self, tokens: int):
        """One eligible admission matched a resident prefix: ``tokens``
        prompt positions were mapped from the index instead of
        prefilled."""
        stat_registry.get("serving.prefix.hits").add(1)
        if tokens > 0:
            stat_registry.get("serving.prefix.hit_tokens").add(int(tokens))

    def on_prefix_miss(self, n: int = 1):
        stat_registry.get("serving.prefix.misses").add(n)

    def on_prefix_evict(self, n: int = 1):
        """Refcount-0 cached pages reclaimed (LRU, leaf-first) to cover
        a live allocation."""
        stat_registry.get("serving.prefix.evictions").add(n)

    def on_prefix_cow(self, n: int = 1):
        """Copy-on-write page copies: a sequence diverged inside a
        shared page and received a private device-side copy."""
        stat_registry.get("serving.prefix.cow").add(n)

    def set_prefix_cached_tokens(self, tokens: int):
        stat_registry.get("serving.prefix.cached_tokens").set(int(tokens))

    # --- tiered KV transport ------------------------------------
    def on_prefix_demote(self, n: int = 1):
        """An evicted page's payload was captured into the host tier
        (device→host gather) instead of discarded."""
        stat_registry.get("serving.prefix.demotions").add(n)

    def on_prefix_promote(self, n: int = 1):
        """A tier hit was restored into a fresh device page (host→device
        scatter) and re-published — a re-prefill avoided."""
        stat_registry.get("serving.prefix.promotions").add(n)

    def set_tier_pages(self, host: int, disk: int):
        stat_registry.get("serving.prefix.host_pages").set(int(host))
        stat_registry.get("serving.prefix.disk_pages").set(int(disk))

    def on_ship(self, pages: int, seconds: float):
        """One prefill→decode handoff: ``pages`` KV pages travelled
        inside an EngineSnapshot in ``seconds`` (gather on the prefill
        replica through re-admission on the decode replica)."""
        if pages > 0:
            stat_registry.get("serving.disagg.shipped_pages").add(
                int(pages))
        stat_registry.histogram("serving.disagg.transfer_ms").observe(
            seconds * 1e3)

    # --- speculative decoding (docs/SERVING.md "Speculative decoding") -----
    def on_spec(self, drafted: int, accepted: int, rejected: int,
                rollbacks: int):
        """One verify dispatch's outcome: ``drafted`` tokens were
        teacher-forced, ``accepted`` of them emitted (each one a token
        that skipped a full weight-set stream), ``rejected`` discarded,
        and ``rollbacks`` lanes had their draft cut short.  The
        ``serving.spec.accept_rate`` gauge is the lifetime derived
        ratio (accepted / drafted)."""
        stat_registry.get("serving.spec.drafted").add(int(drafted))
        if accepted:
            stat_registry.get("serving.spec.accepted").add(int(accepted))
        if rejected:
            stat_registry.get("serving.spec.rejected").add(int(rejected))
        if rollbacks:
            stat_registry.get("serving.spec.rollbacks").add(int(rollbacks))
        total_d = stat_registry.get("serving.spec.drafted").get()
        total_a = stat_registry.get("serving.spec.accepted").get()
        if total_d:
            stat_registry.get("serving.spec.accept_rate").set(
                total_a / total_d)

    # --- unified ragged dispatch --------------------------------
    def on_ragged(self, *, decode_rows: int = 0, prefill_rows: int = 0,
                  spec_rows: int = 0, q_bucket: int = 0):
        """One ``serving.ragged_step`` dispatch's row mix: ``decode_rows``
        lanes advanced one position, ``prefill_rows`` prompt positions
        rode along as chunk rows (instead of serializing ahead of the
        decode ticks), ``spec_rows`` positions were teacher-forced for
        speculative verify.  ``q_bucket`` is the step's per-lane
        query-row bucket Q (gauged — 1 in steady decode)."""
        stat_registry.get("serving.ragged.steps").add(1)
        if decode_rows:
            stat_registry.get("serving.ragged.decode_rows").add(
                int(decode_rows))
        if prefill_rows:
            stat_registry.get("serving.ragged.prefill_rows").add(
                int(prefill_rows))
        if spec_rows:
            stat_registry.get("serving.ragged.spec_rows").add(
                int(spec_rows))
        if q_bucket:
            stat_registry.get("serving.ragged.row_bucket").set(
                int(q_bucket))

    # --- mesh-sharded serving -----------------------------------
    def on_shard_config(self, *, tp: int, sp: int, devices: int):
        """Published once at engine construction: the replica's mesh
        shape — ``tp`` head shards × ``sp`` KV-page shards over
        ``devices`` chips.  Gauged (not counted) so a scrape always
        reads the live topology."""
        stat_registry.get("serving.shard.tp").set(int(tp))
        stat_registry.get("serving.shard.sp").set(int(sp))
        stat_registry.get("serving.shard.devices").set(int(devices))

    def on_shard_step(self, n: int = 1):
        """One ragged dispatch executed as a mesh program — its decode
        matmuls ran head-sharded on ``tp`` and/or its paged attention
        page-sharded on ``sp``, with the partial-softmax stats exchange
        inside the step."""
        stat_registry.get("serving.shard.steps").add(n)

    def on_shard_page_gather(self, n: int = 1):
        """One maintenance gather assembled sharded KV pages into a
        host-visible array (snapshot, tier demotion, scrub read) — each
        is a cross-shard collect the single-chip engine does for free."""
        stat_registry.get("serving.shard.page_gathers").add(n)

    def on_shard_page_scatter(self, n: int = 1):
        """One maintenance scatter re-distributed host page payloads
        across the mesh shards (restore, tier promotion, scrub write)."""
        stat_registry.get("serving.shard.page_scatters").add(n)

    # --- numeric guards (docs/SERVING.md "Logit quarantine") -----
    def on_nan_lane(self, n: int = 1):
        """A decode/verify dispatch returned non-finite logits for a
        lane (the device-side guard flag) — each flagged (lane, step)
        counts once."""
        stat_registry.get("serving.guard.nan_lanes").add(n)

    def on_quarantine(self, n: int = 1):
        """A request was quarantined: failed with NumericalFaultError,
        its lane reset and its pages scrubbed + freed."""
        stat_registry.get("serving.guard.quarantines").add(n)

    def on_prefill(self, seconds: float):
        stat_registry.histogram("serving.prefill_latency_ms").observe(
            seconds * 1e3)

    def on_prefill_chunks(self, chunks: int, tokens: int, seconds: float):
        """Chunked-prefill accounting: ``chunks`` device programs covered
        ``tokens`` prompt positions in ``seconds`` (the dispatch-count
        win of parallel prefill shows up as tokens/chunks >> 1)."""
        stat_registry.get("serving.prefill_chunks").add(int(chunks))
        stat_registry.get("serving.prefill_tokens").add(int(tokens))
        with self._lock:
            self._prefill_tokens += int(tokens)
            self._prefill_seconds += seconds

    def on_decode(self, seconds: float):
        """Under the pipelined engine this is the CONSUME-side wait for
        an in-flight step's tokens — near zero when dispatch-ahead hides
        device latency, the full step time in sync_mode."""
        stat_registry.histogram("serving.decode_latency_ms").observe(
            seconds * 1e3)
        stat_registry.windowed(
            "serving.window.decode_latency_ms").observe(seconds * 1e3)

    def on_dispatch_gap(self, seconds: float):
        """Host-side gap between consecutive decode dispatches — the
        pipelining headline: in steady state it tracks device step time
        (host keeps the device fed); spikes are admission/prefill or
        host-scheduling bubbles."""
        stat_registry.histogram("serving.dispatch_gap_ms").observe(
            seconds * 1e3)
        # the dispatch gap IS the fleet's inter-token latency (ITL) in
        # steady decode — windowed under the operator-facing name
        stat_registry.windowed("serving.window.itl_ms").observe(
            seconds * 1e3)

    def on_step(self, *, queue_depth: int, running: int, bucket: int,
                pages_in_use: int, tokens_emitted: int,
                step_seconds: Optional[float] = None,
                kv_cache_bytes: Optional[int] = None):
        now = self._clock()
        with self._lock:
            if self._start is None:
                self._start = now
            self._steps += 1
            self._tokens += tokens_emitted
            if bucket:
                # occupancy is a property of DECODE steps: consume-only
                # steps (the pipelined engine's trailing drains) and
                # idle steps don't dilute the mean
                self._occupancy_sum += running / bucket
                self._occupancy_count += 1
        if bucket:
            # exported per step (the registry/Prometheus view of what
            # snapshot() reports as the mean) — previously derivable
            # only from engine internals
            stat_registry.get("serving.batch_occupancy").set(
                running / bucket)
        if kv_cache_bytes is not None:
            stat_registry.get("serving.kv_cache_bytes").set(
                int(kv_cache_bytes))
        stat_registry.get("serving.queue_depth").set(queue_depth)
        stat_registry.get("serving.running_seqs").set(running)
        stat_registry.get("serving.kv_pages_in_use").set(pages_in_use)
        stat_registry.get("serving.batch_bucket").set(bucket)
        stat_registry.get("serving.steps").add(1)
        if tokens_emitted:
            stat_registry.get("serving.tokens_generated").add(tokens_emitted)
        if step_seconds is not None:
            stat_registry.histogram("serving.step_latency_ms").observe(
                step_seconds * 1e3)

    # --- derived ----------------------------------------------------------
    def snapshot(self) -> dict:
        now = self._clock()
        with self._lock:
            elapsed = (now - self._start) if self._start else 0.0
            snap = {
                "steps": self._steps,
                "tokens_generated": self._tokens,
                "requests_completed": self._completed,
                "elapsed_s": elapsed,
                "tokens_per_sec": (self._tokens / elapsed
                                   if elapsed > 0 else 0.0),
                "mean_batch_occupancy": (
                    self._occupancy_sum / self._occupancy_count
                    if self._occupancy_count else 0.0),
                "mean_ttft_ms": (self._ttft_sum / self._ttft_count * 1e3
                                 if self._ttft_count else 0.0),
                "prefill_tokens": self._prefill_tokens,
                "prefill_tokens_per_sec": (
                    self._prefill_tokens / self._prefill_seconds
                    if self._prefill_seconds > 0 else 0.0),
            }
        snap["aborts"] = stat_registry.get("serving.aborts").get()
        snap["deadline_miss"] = stat_registry.get(
            "serving.deadline_miss").get()
        for short in ("snapshots", "restores", "watchdog_trips",
                      "retries_backoff", "brownout_stage",
                      "snapshot_bytes"):
            snap[short] = stat_registry.get(f"serving.{short}").get()
        snap["prefix"] = {
            short: stat_registry.get(f"serving.prefix.{short}").get()
            for short in ("hits", "misses", "hit_tokens", "evictions",
                          "cow", "cached_tokens", "demotions",
                          "promotions", "host_pages", "disk_pages")}
        snap["spec"] = {
            short: stat_registry.get(f"serving.spec.{short}").get()
            for short in ("drafted", "accepted", "rejected", "rollbacks",
                          "accept_rate")}
        snap["guard"] = {
            short: stat_registry.get(f"serving.guard.{short}").get()
            for short in ("nan_lanes", "quarantines")}
        snap["ragged"] = {
            short: stat_registry.get(f"serving.ragged.{short}").get()
            for short in ("steps", "decode_rows", "prefill_rows",
                          "spec_rows", "row_bucket")}
        snap["disagg"] = {"shipped_pages": stat_registry.get(
            "serving.disagg.shipped_pages").get()}
        snap["shard"] = {
            short: stat_registry.get(f"serving.shard.{short}").get()
            for short in ("tp", "sp", "devices", "steps",
                          "page_gathers", "page_scatters")}
        for name in self.HISTOGRAMS:
            h = stat_registry.histogram(name).snapshot()
            key = name[len("serving."):]
            summary = {k: h[k] for k in
                       ("count", "mean", "p50", "p95", "p99")}
            if key.startswith("disagg."):
                snap["disagg"][key[len("disagg."):]] = summary
            else:
                snap[key] = summary
        snap["window"] = {
            name[len("serving.window."):]: {
                k: w[k] for k in ("count", "mean", "p50", "p95", "p99")}
            for name, w in ((n, stat_registry.windowed(n).snapshot(
                now=now)) for n in self.WINDOWED)}
        return snap


class FrontendMetrics:
    """Request-level observability for the ServingFrontend — the
    ``serving.frontend.*`` registry names (Prometheus-visible through
    the same exposition as every other stat).  Counters/gauges/
    histograms live in the thread-safe registry primitives; the derived
    accumulators are lock-guarded because submit() callers, replica
    pump threads and HTTP handler threads all report concurrently.

    Lifecycle of a request, in metric terms::

        submitted ──► completed   (ttft_ms + e2e_ms histograms)
                  ├─► rejects        queue_cap overload / no replica
                  ├─► cancels        client cancel won the race
                  ├─► deadline_miss  expired queued or mid-decode
                  └─► failures       replica died with no survivor, or
                                     invalid request detected in-pump
        retries: transparent re-queues after a replica failure — NOT a
        terminal state (the request lives on, stream restarted at 0).
    """

    GAUGES = ("serving.frontend.queue_depth", "serving.frontend.inflight")
    COUNTERS = ("serving.frontend.submitted",
                "serving.frontend.completed",
                "serving.frontend.rejects",
                "serving.frontend.cancels",
                "serving.frontend.deadline_miss",
                "serving.frontend.retries",
                "serving.frontend.failures",
                # brownout shed accounting, one counter per reason
                # (docs/SERVING.md "Resilience": shed → clamp → reject)
                "serving.frontend.brownout_shed",
                "serving.frontend.brownout_clamped",
                "serving.frontend.brownout_rejected",
                # warm failover: tokens NOT recomputed thanks to the
                # checkpoint (vs a token-0 restart)
                "serving.frontend.recompute_saved_tokens",
                # restart recovery: requests re-admitted
                # mid-stream from DISK-persisted snapshots by a new
                # frontend process (recover_pending)
                "serving.frontend.recovered")
    HISTOGRAMS = ("serving.frontend.ttft_ms", "serving.frontend.e2e_ms")
    # recent-window twins: client-observed TTFT/e2e over the
    # last minute — what the SLO latency objectives and dashboard read
    WINDOWED = ("serving.frontend.window.ttft_ms",
                "serving.frontend.window.e2e_ms")

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._lock = OrderedLock("serving.metrics")
        self._clock = clock if clock is not None else time.monotonic
        self.reset()

    def reset(self):
        with self._lock:
            self._ttft_sum = 0.0
            self._ttft_count = 0
            self._e2e_sum = 0.0
            self._e2e_count = 0
        for name in self.GAUGES + self.COUNTERS:
            stat_registry.get(name).reset()
        for name in self.HISTOGRAMS:
            stat_registry.histogram(name).reset()
        for name in self.WINDOWED:
            stat_registry.windowed(
                name, _WINDOW_S, _WINDOW_SLICES).configure(
                window_s=_WINDOW_S, slices=_WINDOW_SLICES,
                clock=self._clock)

    # --- event hooks --------------------------------------------------------
    def on_submit(self):
        stat_registry.get("serving.frontend.submitted").add(1)

    def on_reject(self):
        stat_registry.get("serving.frontend.rejects").add(1)

    def on_cancel(self):
        stat_registry.get("serving.frontend.cancels").add(1)

    def on_deadline_miss(self):
        stat_registry.get("serving.frontend.deadline_miss").add(1)

    def on_retry(self):
        stat_registry.get("serving.frontend.retries").add(1)

    def on_brownout_shed(self):
        """A live queued request was shed under brownout (lowest
        deadline slack first)."""
        stat_registry.get("serving.frontend.brownout_shed").add(1)

    def on_brownout_clamp(self):
        """A new submission's max_new_tokens was clamped under
        brownout."""
        stat_registry.get("serving.frontend.brownout_clamped").add(1)

    def on_brownout_reject(self):
        """A new submission was rejected under brownout stage 3."""
        stat_registry.get("serving.frontend.brownout_rejected").add(1)

    def on_recompute_saved(self, tokens: int):
        """Warm failover resumed from a checkpoint: ``tokens`` already-
        emitted tokens did NOT have to be re-decoded (vs token-0
        restart)."""
        if tokens > 0:
            stat_registry.get(
                "serving.frontend.recompute_saved_tokens").add(int(tokens))

    def on_recovered(self):
        """A request was re-admitted mid-stream from a DISK-persisted
        snapshot after a frontend restart (recover_pending)."""
        stat_registry.get("serving.frontend.recovered").add(1)

    def on_failure(self):
        stat_registry.get("serving.frontend.failures").add(1)

    def on_complete(self, ttft_s: Optional[float], e2e_s: float):
        stat_registry.get("serving.frontend.completed").add(1)
        if ttft_s is not None:
            stat_registry.histogram("serving.frontend.ttft_ms").observe(
                ttft_s * 1e3)
            stat_registry.windowed(
                "serving.frontend.window.ttft_ms").observe(ttft_s * 1e3)
        stat_registry.histogram("serving.frontend.e2e_ms").observe(
            e2e_s * 1e3)
        stat_registry.windowed(
            "serving.frontend.window.e2e_ms").observe(e2e_s * 1e3)
        with self._lock:
            if ttft_s is not None:
                self._ttft_sum += ttft_s
                self._ttft_count += 1
            self._e2e_sum += e2e_s
            self._e2e_count += 1

    def set_queue_depth(self, n: int):
        stat_registry.get("serving.frontend.queue_depth").set(int(n))

    def set_inflight(self, n: int):
        stat_registry.get("serving.frontend.inflight").set(int(n))

    # --- derived ------------------------------------------------------------
    def snapshot(self) -> dict:
        snap = {}
        for name in self.GAUGES + self.COUNTERS:
            snap[name[len("serving.frontend."):]] = \
                stat_registry.get(name).get()
        with self._lock:
            snap["mean_ttft_ms"] = (self._ttft_sum / self._ttft_count * 1e3
                                    if self._ttft_count else 0.0)
            snap["mean_e2e_ms"] = (self._e2e_sum / self._e2e_count * 1e3
                                   if self._e2e_count else 0.0)
        for name in self.HISTOGRAMS:
            h = stat_registry.histogram(name).snapshot()
            snap[name[len("serving.frontend."):]] = {
                k: h[k] for k in ("count", "mean", "p50", "p95", "p99")}
        now = self._clock()
        snap["window"] = {
            name[len("serving.frontend.window."):]: {
                k: w[k] for k in ("count", "mean", "p50", "p95", "p99")}
            for name, w in ((n, stat_registry.windowed(n).snapshot(
                now=now)) for n in self.WINDOWED)}
        return snap


# replica lifecycle states as gauge values (serving.fleet.state):
# healthy replicas sit at 0 so ANY non-zero fleet cell is actionable
_STATE_CODE = {"healthy": 0, "suspect": 1, "draining": 2, "dead": 3}


class FleetMetrics:
    """Fleet rollup: merges per-replica router status into
    ``LabeledGauge`` families keyed by ``{replica, role}``, so ONE
    Prometheus scrape separates the prefill pool from the decode pool
    (before this, per-replica state existed only inside the /healthz
    JSON — invisible to the metrics pipeline).

    ``refresh()`` re-derives every family from the router's current
    replica list; it is called from ``ServingFrontend.healthz()`` /
    ``stats()`` (and therefore on every scrape of those surfaces), not
    from the hot pump loop — the rollup is a read-side aggregation, so
    steady decode pays nothing for it.
    """

    LABELED = ("serving.fleet.state", "serving.fleet.steps",
               "serving.fleet.outstanding_tokens",
               "serving.fleet.inbox_depth", "serving.fleet.healthy")

    def __init__(self, router):
        self._router = router

    def refresh(self) -> dict:
        """Re-export the rollup; returns the router healthz payload the
        gauges were derived from (callers embed it, so one router lock
        pass serves both surfaces)."""
        hz = self._router.healthz()
        per_replica = {
            "serving.fleet.state": lambda r: _STATE_CODE.get(
                r["state"], -1),
            "serving.fleet.steps": lambda r: r["steps"],
            "serving.fleet.outstanding_tokens":
                lambda r: r["outstanding_tokens"],
            "serving.fleet.inbox_depth": lambda r: r["inbox_depth"],
        }
        for name, fn in per_replica.items():
            g = stat_registry.labeled_gauge(name)
            g.reset()
            for rep in hz["replicas"]:
                g.set(fn(rep), replica=rep["id"], role=rep["role"])
        g = stat_registry.labeled_gauge("serving.fleet.healthy")
        g.reset()
        for role, n in hz["healthy_by_role"].items():
            g.set(n, role=role)
        return hz
