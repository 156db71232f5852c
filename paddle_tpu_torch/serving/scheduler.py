"""Continuous-batching scheduler (policy only — no device compute) —
``Request``, ``Sequence`` and ``Scheduler`` from
``paddle_tpu/serving/scheduler.py``.

Policies
--------
admission    FIFO; a request enters when a batch slot is free AND the
             paged KV cache can supply pages covering its prompt.
batching     the decode batch is padded up to the smallest configured
             bucket >= len(running) (pow2 buckets by default).
preemption   on page exhaustion mid-decode the YOUNGEST other running
             sequence is evicted (recompute-style: its pages are freed
             and its request returns to the queue FRONT; greedy decode is
             deterministic, so its final output is unchanged).  An
             already-expired running sequence is preferred as victim.
retirement   EOS or max_new_tokens; pages return to the free list.
deadline     a request may carry an absolute ``deadline`` (monotonic
             seconds); ``expire_queued`` drops expired waiting requests
             before admission, and the engine aborts expired running
             ones.

reservation  ``reserve`` grows a table WITHOUT preemption, for capacity
             that may be rolled back (the fused K-step horizon, spec-decode
             draft windows).
prefix       with a prefix cache attached (``Scheduler.prefix_cache``),
             admission maps the longest resident full-page prompt prefix
             into the new table and allocates only the uncached suffix.
resume       a request carrying an ``EngineSnapshot`` (``Request.resume``)
             allocates pages for every KV position the snapshot holds and
             starts mid-stream at its checkpoint.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np

from ..framework.errors import InvalidArgumentError, ResourceExhaustedError
from ..profiler.flight_recorder import EV_PREEMPTED
from ..profiler.flight_recorder import recorder as flight
from ..utils.bucketing import pow2_buckets, smallest_bucket
from .kv_cache import PagedKVCache

__all__ = ["Request", "Sequence", "Scheduler"]

_req_counter = itertools.count()


@dataclass
class Request:
    """One generation request as admitted by the engine."""
    prompt: np.ndarray                  # [P] int32 token ids
    max_new_tokens: int = 32
    request_id: str = ""
    arrival_time: float = field(default_factory=time.monotonic)
    # absolute time.monotonic() seconds; None = no SLO
    deadline: Optional[float] = None
    # warm-failover resume state (a resilience.EngineSnapshot): admission
    # uploads the snapshot's KV pages instead of prefilling, and the
    # sequence starts mid-stream at the checkpoint.  The scheduler reads
    # only .pos / .next_token / .generated / .kv_len.
    resume: Optional[object] = field(default=None, repr=False)
    # the per-request prefix-cache OPT-OUT: False skips both the index
    # lookup and the sealing of this request's pages.  Ignored when the
    # engine has no prefix cache; resume requests always restore private.
    use_prefix_cache: bool = True

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise InvalidArgumentError("empty prompt")
        if not self.request_id:
            self.request_id = f"req-{next(_req_counter)}"

    def expired(self, now: float) -> bool:
        """True once ``now >= deadline`` (callers own the clock)."""
        if self.deadline is None:
            return False
        return now >= self.deadline


class Sequence:
    """In-flight decode state for one admitted request (host side)."""

    def __init__(self, request: Request):
        self.request = request
        # pos = the KV position the NEXT decode step writes; after
        # prefilling prompt[:-1] that is P-1 (the last prompt token is
        # consumed by the first decode step, mirroring generate()).
        # Under the pipelined engine pos advances at DISPATCH time.
        self.pos = 0
        self.next_token = int(request.prompt[-1])
        self.generated: List[int] = []
        if request.resume is not None:
            # warm-failover resume: start mid-stream at the checkpoint
            self.next_token = int(request.resume.next_token)
            self.generated = [int(t) for t in request.resume.generated]
        self.preemptions = 0
        self.first_token_time: Optional[float] = None
        # prefix-cache admission outcome (set by Scheduler.admit): tokens
        # covered by shared index pages (prefill starts there) and the
        # (src, dst) of a pending copy-on-write page the engine copies on
        # the device before the first dispatch that reads it
        self.cached_tokens = 0
        self.cow_pair: Optional[tuple] = None
        # a preemption bumps the epoch, so tokens dispatched before the
        # reset are dropped on consume (the recompute replays them)
        self.epoch = 0
        self.done = False
        # set when a dispatch returned non-finite logits for this lane
        self.numeric_fault = False

    @property
    def seq_id(self) -> str:
        return self.request.request_id

    @property
    def num_generated(self) -> int:
        return len(self.generated)

    def reset(self):
        """Recompute-preemption: back to the unprefilled state — or, for a
        snapshot-resumed sequence, back to its checkpoint (re-admission
        uploads the snapshot's pages again)."""
        resume = self.request.resume
        self.pos = 0
        if resume is not None:
            self.next_token = int(resume.next_token)
            self.generated = [int(t) for t in resume.generated]
        else:
            self.next_token = int(self.request.prompt[-1])
            self.generated = []
        self.preemptions += 1
        self.epoch += 1


class Scheduler:
    """Admission queue + running set over a PagedKVCache."""

    def __init__(self, kv_cache: PagedKVCache, max_batch_size: int,
                 bucket_sizes: Optional[List[int]] = None):
        self.cache = kv_cache
        self.max_batch_size = int(max_batch_size)
        if bucket_sizes is None:
            bucket_sizes = pow2_buckets(self.max_batch_size)
        self.bucket_sizes = sorted(set(int(b) for b in bucket_sizes))
        if self.bucket_sizes[-1] < self.max_batch_size:
            raise InvalidArgumentError(
                "largest bucket must cover max_batch_size")
        self.waiting: Deque[Request] = deque()
        self.running: List[Sequence] = []
        self.num_preemptions = 0
        # optional serving.prefix_cache.PrefixCache (set by the engine)
        self.prefix_cache = None

    # --- queue ------------------------------------------------------------
    def add(self, request: Request):
        self.waiting.append(request)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def queue_depth(self) -> int:
        return len(self.waiting)

    def expire_queued(self, now: Optional[float] = None) -> List[Request]:
        """Remove and return every waiting request whose deadline has
        passed — they are never admitted and hold no pages."""
        if not self.waiting:
            return []
        now = time.monotonic() if now is None else now
        expired = [r for r in self.waiting if r.expired(now)]
        if expired:
            self.waiting = deque(r for r in self.waiting
                                 if not r.expired(now))
        return expired

    # --- admission --------------------------------------------------------
    def admit(self) -> List[Sequence]:
        """Move waiting requests into the running set while a batch slot
        is free and the cache can cover the prompt; FIFO order, so a big
        stuck request head-of-line blocks.

        With a prefix cache, an eligible request (not a resume, not opted
        out) first maps the index's longest resident full-page prompt
        prefix through ``cache.share`` and allocates only the suffix; when
        the match covers the WHOLE prompt, the first decode write
        (position P-1) would land in a shared page, so the last matched
        page is swapped copy-on-write (``cache.cow_page``).  Any failure
        on the way (exhaustion, a chaos ``kv.allocate`` denial) rolls the
        mapping back and defers the admission.  The full prompt pages
        below position P-1 are sealed at once, so a later request of the
        same ``admit`` already shares them."""
        admitted: List[Sequence] = []
        while self.waiting and len(self.running) < self.max_batch_size:
            req = self.waiting[0]
            # a resumed request needs pages for every KV position its
            # snapshot carries, not just the prompt
            kv_need = (int(req.resume.kv_len) if req.resume is not None
                       else len(req.prompt))
            eligible = (self.prefix_cache is not None and req.resume is None
                        and req.use_prefix_cache)
            matched: List[int] = []
            if eligible:
                matched = self.prefix_cache.match(req.prompt)
                if matched and not self.cache.share(req.request_id,
                                                    matched):
                    matched = []
            if not self.cache.allocate(req.request_id, kv_need):
                if matched:
                    # roll the mapping back (a pure decref: the pages stay
                    # resident for the retry)
                    self.cache.free(req.request_id)
                break
            matched_tokens = len(matched) * self.cache.page_size
            cow_pair = None
            if matched_tokens >= len(req.prompt):
                cow_pair = self.cache.cow_page(req.request_id,
                                               len(matched) - 1)
                if cow_pair is None:
                    self.cache.free(req.request_id)
                    break
            self.waiting.popleft()
            seq = Sequence(req)
            seq.pos = (int(req.resume.pos) if req.resume is not None
                       else len(req.prompt) - 1)
            seq.cached_tokens = matched_tokens
            seq.cow_pair = cow_pair
            self.running.append(seq)
            admitted.append(seq)
            if eligible:
                self.prefix_cache.on_admission(matched_tokens)
                full = (len(req.prompt) - 1) // self.cache.page_size
                if full > 0:
                    self.prefix_cache.insert(
                        req.prompt,
                        self.cache.seq_page_ids(req.request_id), full)
        return admitted

    # --- decode-time page growth -----------------------------------------
    def ensure_decode_pages(self,
                            seqs: Optional[List[Sequence]] = None
                            ) -> List[Sequence]:
        """Guarantee every sequence in ``seqs`` (default: all running)
        has a page for the position it writes this step (pos), preempting
        the youngest other running sequence on exhaustion.  Returns the
        preempted sequences."""
        preempted: List[Sequence] = []
        for seq in list(seqs if seqs is not None else self.running):
            if seq not in self.running:
                continue    # became a victim earlier in this very loop
            while not self.cache.allocate(seq.seq_id, seq.pos + 1):
                victim = self._pick_victim(exclude=seq)
                if victim is None:
                    raise ResourceExhaustedError(
                        f"KV cache exhausted: sequence {seq.seq_id} needs "
                        f"{self.cache.pages_needed(seq.pos + 1)} pages but "
                        f"only {self.cache.free_pages} free and no other "
                        "sequence to preempt — size num_pages/pages_per_seq "
                        "for the workload")
                self.preempt(victim)
                preempted.append(victim)
        return preempted

    def reserve(self, seq: Sequence, num_tokens: int) -> bool:
        """Reserve pages covering ``num_tokens`` KV positions WITHOUT
        preemption — speculative capacity (the fused K-step horizon,
        spec-decode draft windows) must never evict a live sequence to
        make room for tokens that may be rolled back.  Partial growth
        is kept on failure (the pages are real and get used within the
        horizon); the caller degrades to plain decode for the step."""
        return self.cache.allocate(seq.seq_id, num_tokens)

    def _pick_victim(self, exclude: Sequence) -> Optional[Sequence]:
        # an already-expired sequence is a free victim: the engine aborts
        # it before it decodes again
        now = time.monotonic()
        for seq in reversed(self.running):
            if seq is not exclude and seq.request.expired(now):
                return seq
        for seq in reversed(self.running):      # youngest first
            if seq is not exclude:
                return seq
        return None

    def preempt(self, seq: Sequence):
        """Recompute-style eviction: free pages, reset, requeue at FRONT."""
        self.cache.free(seq.seq_id)
        self.running.remove(seq)
        seq.reset()
        self.waiting.appendleft(seq.request)
        self.num_preemptions += 1
        flight.request_event(seq.seq_id, EV_PREEMPTED,
                             preemptions=seq.preemptions)

    # --- retirement -------------------------------------------------------
    def finish(self, seq: Sequence):
        self.cache.free(seq.seq_id)
        self.running.remove(seq)

    # --- batching ---------------------------------------------------------
    def bucket(self) -> int:
        """Smallest configured bucket covering the running set."""
        return smallest_bucket(len(self.running), self.bucket_sizes)

    def seq_lens(self) -> dict:
        """{seq_id: valid KV length} for cache fragmentation stats."""
        return {s.seq_id: s.pos for s in self.running}
