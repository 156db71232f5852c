"""Serving observability — ``ServingMetrics`` from
``paddle_tpu/serving/metrics.py``.

Every engine step publishes gauges/counters into
``framework.monitor.stat_registry`` under the ``serving.*`` namespace,
latency histograms (step, prefill, decode, TTFT, dispatch gap), and
keeps host-side accumulators for the derived
rates ``snapshot()`` reports (tokens/sec, mean TTFT, mean batch
occupancy).  The registry names are PROCESS-GLOBAL: constructing a new
ServingMetrics resets them.

Not in this slice: ``FrontendMetrics`` and ``FleetMetrics`` (the
frontend and router, ROADMAP queue 1 step C) and the recent-window
histograms that their SLO tracker and healthz read.  The frontend's
brownout counters live here until the frontend is ported, beside the
``serving.brownout_stage`` gauge that ``resilience.BrownoutController``
sets.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from ..framework.concurrency import OrderedLock
from ..framework.monitor import stat_registry

__all__ = ["ServingMetrics"]


class ServingMetrics:
    """Aggregates per-step serving stats; ints mirror into the stat
    registry, latency samples into its histograms.  Thread-safe."""

    GAUGES = ("serving.queue_depth", "serving.running_seqs",
              "serving.kv_pages_in_use", "serving.batch_bucket",
              "serving.kv_cache_bytes", "serving.batch_occupancy",
              # per-lane query-row bucket (Q) of the latest ragged step
              "serving.ragged.row_bucket",
              # speculative decoding: lifetime fraction of drafted
              # tokens the verifier accepted
              "serving.spec.accept_rate",
              # mesh-sharded serving: the replica's mesh shape — tensor
              # (head) shards, sequence (page) shards and their product
              # (device slots per replica)
              "serving.shard.tp", "serving.shard.sp",
              "serving.shard.devices",
              # resilience: the latest snapshot's host bytes and the
              # brownout stage (0 normal .. 3 reject)
              "serving.snapshot_bytes", "serving.brownout_stage",
              # prefix cache: tokens' worth of KV the radix index can
              # serve (resident sealed pages)
              "serving.prefix.cached_tokens")
    COUNTERS = ("serving.steps", "serving.tokens_generated",
                "serving.requests_admitted", "serving.requests_completed",
                "serving.preemptions", "serving.prefill_chunks",
                "serving.prefill_tokens", "serving.aborts",
                "serving.deadline_miss",
                # numeric guards: lanes whose logits came back non-finite
                # and the requests quarantined as a result
                "serving.guard.nan_lanes", "serving.guard.quarantines",
                # unified ragged dispatch: mixed-batch dispatches and the
                # rows they carried per kind
                "serving.ragged.steps", "serving.ragged.decode_rows",
                "serving.ragged.prefill_rows", "serving.ragged.spec_rows",
                # speculative decoding: drafted tokens submitted to the
                # verifier, the split into accepted and rejected, and the
                # lanes whose draft was cut short
                "serving.spec.drafted", "serving.spec.accepted",
                "serving.spec.rejected", "serving.spec.rollbacks",
                # mesh-sharded serving: ragged dispatches that ran as one
                # mesh step (every one crosses the tp/sp collectives), and
                # maintenance traffic that assembled (gather) or
                # re-distributed (scatter) sharded KV pages
                "serving.shard.steps", "serving.shard.page_gathers",
                "serving.shard.page_scatters",
                # resilience: request checkpoints taken and restored, the
                # watchdog's trips, placement retries that backed off
                "serving.snapshots", "serving.restores",
                "serving.watchdog_trips", "serving.retries_backoff",
                # prefix cache: per-admission hit/miss, the prefill tokens
                # the hits skipped, LRU page evictions and copy-on-write
                # page copies
                "serving.prefix.hits", "serving.prefix.misses",
                "serving.prefix.hit_tokens", "serving.prefix.evictions",
                "serving.prefix.cow",
                # brownout: queued requests shed, budgets clamped,
                # submissions rejected
                "serving.frontend.brownout_shed",
                "serving.frontend.brownout_clamped",
                "serving.frontend.brownout_rejected")
    HISTOGRAMS = ("serving.step_latency_ms", "serving.prefill_latency_ms",
                  "serving.decode_latency_ms", "serving.ttft_ms",
                  "serving.dispatch_gap_ms", "serving.failover_recovery_ms")

    def __init__(self, clock: Optional[Callable[[], float]] = None):
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

    def on_completion(self, n: int = 1):
        with self._lock:
            self._completed += n
        stat_registry.get("serving.requests_completed").add(n)

    def on_preemption(self, n: int = 1):
        stat_registry.get("serving.preemptions").add(n)

    def on_abort(self, n: int = 1):
        """A queued or in-flight sequence was retired without output."""
        stat_registry.get("serving.aborts").add(n)

    def on_deadline_miss(self, n: int = 1):
        stat_registry.get("serving.deadline_miss").add(n)

    # --- resilience --------------------------------------------------------
    def on_snapshot(self, nbytes: int):
        """One request checkpoint taken; the gauge holds the latest
        snapshot's size (tokens + KV pages, host bytes)."""
        stat_registry.get("serving.snapshots").add(1)
        stat_registry.get("serving.snapshot_bytes").set(int(nbytes))

    def on_restore(self, n: int = 1):
        """A snapshot was re-admitted mid-stream (warm failover)."""
        stat_registry.get("serving.restores").add(n)

    def on_watchdog_trip(self, n: int = 1):
        """The watchdog pulled a replica from the routing pool."""
        stat_registry.get("serving.watchdog_trips").add(n)

    def on_retry_backoff(self, n: int = 1):
        """One placement retry slept through its backoff."""
        stat_registry.get("serving.retries_backoff").add(n)

    def on_failover_recovery(self, seconds: float):
        """Replica death to the first token decoded by the survivor."""
        stat_registry.histogram("serving.failover_recovery_ms").observe(
            seconds * 1e3)

    def on_brownout_shed(self):
        """A queued request was shed under brownout (lowest deadline
        slack first)."""
        stat_registry.get("serving.frontend.brownout_shed").add(1)

    def on_brownout_clamp(self):
        """A new submission's max_new_tokens was clamped under
        brownout."""
        stat_registry.get("serving.frontend.brownout_clamped").add(1)

    def on_brownout_reject(self):
        """A new submission was rejected under brownout stage 3."""
        stat_registry.get("serving.frontend.brownout_rejected").add(1)

    # --- prefix cache --------------------------------------------------------
    def on_prefix_hit(self, tokens: int):
        """One eligible admission matched a resident prefix: ``tokens``
        prompt positions were mapped from the index, not prefilled."""
        stat_registry.get("serving.prefix.hits").add(1)
        if tokens > 0:
            stat_registry.get("serving.prefix.hit_tokens").add(int(tokens))

    def on_prefix_miss(self, n: int = 1):
        stat_registry.get("serving.prefix.misses").add(n)

    def on_prefix_evict(self, n: int = 1):
        """Refcount-0 cached pages reclaimed (LRU, leaf-first) to cover a
        live allocation."""
        stat_registry.get("serving.prefix.evictions").add(n)

    def on_prefix_cow(self, n: int = 1):
        """Copy-on-write page copies: a sequence was about to write into
        a shared page and received a private copy on the device."""
        stat_registry.get("serving.prefix.cow").add(n)

    def set_prefix_cached_tokens(self, tokens: int):
        stat_registry.get("serving.prefix.cached_tokens").set(int(tokens))

    def on_ragged(self, *, decode_rows: int = 0, prefill_rows: int = 0,
                  spec_rows: int = 0, q_bucket: int = 0):
        """One ragged dispatch's row mix: ``decode_rows`` lanes advanced
        one position, ``prefill_rows`` prompt positions rode along as
        chunk rows, ``spec_rows`` positions were teacher-forced for
        speculative verify; ``q_bucket`` is the step's per-lane row
        bucket Q."""
        stat_registry.get("serving.ragged.steps").add(1)
        if decode_rows:
            stat_registry.get("serving.ragged.decode_rows").add(
                int(decode_rows))
        if prefill_rows:
            stat_registry.get("serving.ragged.prefill_rows").add(
                int(prefill_rows))
        if spec_rows:
            stat_registry.get("serving.ragged.spec_rows").add(int(spec_rows))
        if q_bucket:
            stat_registry.get("serving.ragged.row_bucket").set(int(q_bucket))

    def on_spec(self, drafted: int, accepted: int, rejected: int,
                rollbacks: int):
        """One verify dispatch's outcome: ``drafted`` tokens were
        teacher-forced, ``accepted`` of them emitted, ``rejected``
        discarded, and ``rollbacks`` lanes had their draft cut short.
        The ``serving.spec.accept_rate`` gauge is the lifetime ratio
        accepted / drafted."""
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

    # --- mesh-sharded serving ----------------------------------------------
    def on_shard_config(self, *, tp: int, sp: int, devices: int):
        """Published once at engine construction: the replica's mesh
        shape — ``tp`` head shards x ``sp`` KV-page shards over
        ``devices`` slots.  Gauged (not counted), so a scrape always reads
        the live topology."""
        stat_registry.get("serving.shard.tp").set(int(tp))
        stat_registry.get("serving.shard.sp").set(int(sp))
        stat_registry.get("serving.shard.devices").set(int(devices))

    def on_shard_step(self, n: int = 1):
        """One ragged dispatch ran as a mesh step: its matmuls
        head-sharded over ``tp`` and/or its paged attention page-sharded
        over ``sp``, with the partial-softmax exchange inside the step."""
        stat_registry.get("serving.shard.steps").add(n)

    def on_shard_page_gather(self, n: int = 1):
        """One maintenance gather assembled sharded KV pages into the
        global layout (a spec-rollback save) — a cross-shard collect the
        single-device engine does not need."""
        stat_registry.get("serving.shard.page_gathers").add(n)

    def on_shard_page_scatter(self, n: int = 1):
        """One maintenance scatter re-distributed global page payloads
        across the shards (a quarantine scrub, a spec-rollback restore)."""
        stat_registry.get("serving.shard.page_scatters").add(n)

    def on_nan_lane(self, n: int = 1):
        """A dispatch returned non-finite logits for a lane."""
        stat_registry.get("serving.guard.nan_lanes").add(n)

    def on_quarantine(self, n: int = 1):
        """A request was failed by the numeric guard (lane reset, pages
        scrubbed and freed)."""
        stat_registry.get("serving.guard.quarantines").add(n)

    def on_prefill(self, seconds: float):
        stat_registry.histogram("serving.prefill_latency_ms").observe(
            seconds * 1e3)

    def on_prefill_chunks(self, chunks: int, tokens: int, seconds: float):
        """``chunks`` dispatches covered ``tokens`` prompt positions."""
        stat_registry.get("serving.prefill_chunks").add(int(chunks))
        stat_registry.get("serving.prefill_tokens").add(int(tokens))
        with self._lock:
            self._prefill_tokens += int(tokens)
            self._prefill_seconds += seconds

    def on_decode(self, seconds: float):
        """The consume-side wait for an in-flight step's tokens."""
        stat_registry.histogram("serving.decode_latency_ms").observe(
            seconds * 1e3)

    def on_dispatch_gap(self, seconds: float):
        """Host-side gap between consecutive dispatches — the
        inter-token latency in steady decode."""
        stat_registry.histogram("serving.dispatch_gap_ms").observe(
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
                # occupancy is a property of dispatching steps
                self._occupancy_sum += running / bucket
                self._occupancy_count += 1
        if bucket:
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
                          "cow", "cached_tokens")}
        snap["brownout"] = {
            short: stat_registry.get(
                f"serving.frontend.brownout_{short}").get()
            for short in ("shed", "clamped", "rejected")}
        snap["guard"] = {
            short: stat_registry.get(f"serving.guard.{short}").get()
            for short in ("nan_lanes", "quarantines")}
        snap["spec"] = {
            short: stat_registry.get(f"serving.spec.{short}").get()
            for short in ("drafted", "accepted", "rejected", "rollbacks",
                          "accept_rate")}
        snap["ragged"] = {
            short: stat_registry.get(f"serving.ragged.{short}").get()
            for short in ("steps", "decode_rows", "prefill_rows",
                          "spec_rows", "row_bucket")}
        snap["shard"] = {
            short: stat_registry.get(f"serving.shard.{short}").get()
            for short in ("tp", "sp", "devices", "steps", "page_gathers",
                          "page_scatters")}
        for name in self.HISTOGRAMS:
            h = stat_registry.histogram(name).snapshot()
            snap[name[len("serving."):]] = {
                k: h[k] for k in ("count", "mean", "p50", "p95", "p99")}
        return snap
