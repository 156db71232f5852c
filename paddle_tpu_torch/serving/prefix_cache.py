"""Prefix cache: radix index + refcounted copy-on-write page sharing —
``PrefixCache`` from ``paddle_tpu/serving/prefix_cache.py``.

Shared prompt prefixes (system prompts, few-shot templates, multi-turn
history) already sit in the paged KV pools; this HOST-side index finds
resident pages by token content, and the paged attention kernels stay
as they are — a sequence's page table simply starts with somebody
else's pages.

- **Radix index**: a trie keyed on PAGE-GRANULARITY token-id chunks —
  one node per full page of ``page_size`` token ids, mapping the chunk
  chain to the resident physical page holding that prefix's KV.  Only
  FULL pages are indexed, so a hit is always immutable content.
- **Refcounts** (``kv_cache.PagedKVCache``): ``match`` + ``share`` map
  the hit pages into the new sequence's table head; retirement, abort
  and preemption decref — a shared page is never freed while a sequence
  references it.
- **Copy-on-write** (``cow_page`` + the engine's in-place page copy):
  when the whole prompt is covered, the first decode write (position
  P-1) lands inside the last matched page — the host swaps in a fresh
  page, the engine copies the payload on the device, and the shared
  original is never written.
- **Prefill skip**: admission starts the chunked prefill at the first
  uncached token.
- **Eviction**: pages whose refcount is 0 stay RESIDENT in the index
  (evictable, not free) and are reclaimed leaf-first in LRU order only
  when an allocation would otherwise fail.

Sealing: at ADMISSION a sequence seals every full prompt page strictly
before the page its first decode write touches; at RETIREMENT it seals
the remaining full pages, generated tokens included.  Greedy decode is
deterministic, so a page's content is a function of the token ids
keying it, and a cached stream equals the uncached one.

Quantized KV: ``native`` and ``int8_static`` (calibrated scales are
engine configuration) index normally; ``int8_dynamic`` bypasses the
index (the engine never builds one), because a reader-triggered scale
growth would requantize content under every other reader.

Tiers (``kv_transport.PageTransport``, attached by an engine built
with ``kv_tiering``): every eviction funnels through ``_drop_node``,
which demotes the page's payload before releasing it, and
``promote_for`` brings a demoted chain back into the index at
admission.

Threading: owned by the engine's driving thread, like the scheduler —
no locks, no device calls.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from ..framework.errors import InvalidArgumentError
from ..profiler.flight_recorder import recorder as flight
from .kv_cache import PagedKVCache

__all__ = ["PrefixCache"]


class _Node:
    """One full-page chunk in the radix trie: ``chunk`` is the page's
    token ids (the edge label from the parent), ``page`` the resident
    physical page holding that prefix's KV, ``lru`` a monotonic touch
    stamp (eviction takes the smallest, leaf-first)."""

    __slots__ = ("chunk", "page", "parent", "children", "lru")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.lru = 0


class PrefixCache:
    """Radix index over resident KV pages, keyed by token content.

    Owned by one ``ServingEngine`` (page ids are pool-local); attaches
    itself as the ``PagedKVCache`` reclaimer so allocation pressure
    evicts cached pages before failing or preempting.  ``metrics`` is
    the engine's ``ServingMetrics`` (the ``serving.prefix.*`` counters
    and the ``serving.prefix.cached_tokens`` gauge)."""

    def __init__(self, cache: PagedKVCache, metrics=None):
        if cache.page_size < 1:
            raise InvalidArgumentError("page_size must be >= 1")
        self.cache = cache
        self.page_size = cache.page_size
        self.metrics = metrics
        self._root = _Node((), 0, None)
        self._by_page: Dict[int, _Node] = {}
        self._clock = itertools.count(1)
        # plain counters mirrored into the metrics registry (stats()
        # works without a metrics object)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.cow_copies = 0
        # optional kv_transport.PageTransport: evictions demote through
        # it, promote_for restores through it (None = tiers off)
        self.transport = None
        # pages sealed at admission whose device payload has NOT been
        # written yet: the ragged engine's prefill plans write a prompt's
        # pages across later steps, so a page can sit in the index before
        # its KV exists.  The engine maintains membership, readers gate
        # on it (the dispatch barrier), and eviction never demotes such
        # a page — it has no payload to capture.
        self.unwritten: Set[int] = set()
        cache.set_reclaimer(self.evict)

    def attach_transport(self, transport):
        """Attach the tiered page transport (the engine's wiring)."""
        self.transport = transport

    # --- lookup -------------------------------------------------------------
    def _chunks(self, tokens: np.ndarray, limit_pages: int):
        toks = np.asarray(tokens).reshape(-1)
        for j in range(min(int(len(toks)) // self.page_size, limit_pages)):
            yield tuple(int(t) for t in
                        toks[j * self.page_size:(j + 1) * self.page_size])

    def match(self, prompt: np.ndarray) -> List[int]:
        """Longest resident full-page prefix of ``prompt``: the physical
        page ids covering its first ``len(result) * page_size`` tokens,
        in position order.  Touches the matched chain's LRU stamps; does
        NOT incref — the caller maps the pages through ``cache.share`` in
        the same host step."""
        node = self._root
        pages: List[int] = []
        stamp = next(self._clock)
        for chunk in self._chunks(prompt, self.cache.pages_per_seq):
            child = node.children.get(chunk)
            if child is None:
                break
            child.lru = stamp
            pages.append(child.page)
            node = child
        return pages

    # --- publication --------------------------------------------------------
    def insert(self, tokens: np.ndarray, page_ids: List[int],
               full_pages: int) -> int:
        """Seal ``page_ids[:full_pages]`` into the index under the chunk
        chain of ``tokens`` — each page must hold the finished KV of its
        full page of token ids and never be written again by its owner.
        An existing node keeps its page (first publisher wins; the
        duplicate stays private and frees normally).  Returns how many
        pages were newly indexed."""
        node = self._root
        added = 0
        stamp = next(self._clock)
        for j, chunk in enumerate(self._chunks(tokens, full_pages)):
            child = node.children.get(chunk)
            if child is None:
                page = int(page_ids[j])
                child = _Node(chunk, page, node)
                node.children[chunk] = child
                self._by_page[page] = child
                self.cache.pin_cached(page)
                added += 1
            child.lru = stamp
            node = child
        if added:
            self._publish_gauge()
        return added

    # --- eviction -----------------------------------------------------------
    def evict(self, n_pages: int) -> int:
        """Release up to ``n_pages`` refcount-0 cached pages back to the
        allocator, leaf-first in LRU order (the PagedKVCache reclaimer
        hook).  Pages still referenced by sequences are never touched.
        Returns the number released."""
        released = 0
        while released < n_pages:
            # one scan per generation: every evictable leaf, LRU first up
            # to the deficit; rescan only if that exposed new leaves
            leaves = [node for page, node in self._by_page.items()
                      if not node.children
                      and self.cache.ref_count(page) == 0]
            if not leaves:
                break
            leaves.sort(key=lambda n: n.lru)
            for victim in leaves[: n_pages - released]:
                self._drop_node(victim)
                released += 1
                self.evictions += 1
                if self.metrics is not None:
                    self.metrics.on_prefix_evict()
        if released:
            self._publish_gauge()
            flight.on_transition(
                "prefix.evicted", "index",
                f"released={released} resident_pages={len(self._by_page)}")
        return released

    def invalidate_pages(self, page_ids: Iterable[int]) -> int:
        """Un-publish pages whose device payload never materialized — a
        mid-plan preemption or abort struck their writer before its
        prefill plan wrote them.  Descendant nodes belong to barrier-held
        sharers whose own cascade drop removes them.  Returns the number
        of nodes dropped."""
        dropped = 0
        for page in sorted(int(p) for p in page_ids):
            self.unwritten.discard(page)
            node = self._by_page.pop(page, None)
            if node is None:
                continue
            if node.parent is not None:
                node.parent.children.pop(node.chunk, None)
            self.cache.release_cached(page)
            dropped += 1
        if dropped:
            self._publish_gauge()
        return dropped

    def _drop_node(self, node: _Node):
        # every eviction funnels through here — the one demotion hook.
        # The transport captures the payload on the host (or declines:
        # window closed, chaos deny, gather failure); the device page is
        # released either way.  A page whose prefill is still in flight
        # holds no payload, so membership in ``unwritten`` is tested
        # BEFORE it is discarded.
        if self.transport is not None and node.page not in self.unwritten:
            self.transport.demote(self._chain_key(node), node.page)
        self.unwritten.discard(node.page)
        del self._by_page[node.page]
        if node.parent is not None:
            node.parent.children.pop(node.chunk, None)
        self.cache.release_cached(node.page)

    @staticmethod
    def _chain_key(node: _Node) -> Tuple[int, ...]:
        """The FULL token chain from the prompt start through ``node``'s
        page — the tier key."""
        chunks: List[Tuple[int, ...]] = []
        walk: Optional[_Node] = node
        while walk is not None and walk.parent is not None:
            chunks.append(walk.chunk)
            walk = walk.parent
        key: List[int] = []
        for chunk in reversed(chunks):
            key.extend(chunk)
        return tuple(key)

    # --- tier promotion -----------------------------------------------------
    def promote_for(self, prompt: np.ndarray) -> int:
        """Extend the resident trie along ``prompt`` from the tiers: where
        the radix walk would fall off, fetch the chain's payload (host
        tier, then disk), take a free page, write it back and publish the
        node — the ``match`` that follows maps it like a resident hit.
        Called at ADMISSION only.  Stops at the first miss (a deeper
        chain cannot be resident without its parents) and never evicts
        to make room.  Returns the pages promoted."""
        if self.transport is None:
            return 0
        node = self._root
        key: List[int] = []
        promoted = 0
        for chunk in self._chunks(prompt, self.cache.pages_per_seq):
            key.extend(chunk)
            child = node.children.get(chunk)
            if child is not None:
                node = child
                continue
            payload = self.transport.fetch(tuple(key))
            if payload is None:
                break
            page = self.cache.take_cached_page()
            if page is None:
                # no free page: stay demoted, the admission re-prefills
                break
            try:
                self.transport.restore_page(page, payload)
            except Exception:  # noqa: BLE001 — degrade to a miss
                self.cache.release_cached(page)
                break
            child = _Node(chunk, page, node)
            node.children[chunk] = child
            self._by_page[page] = child
            child.lru = next(self._clock)
            node = child
            promoted += 1
        if promoted:
            self._publish_gauge()
        return promoted

    # --- accounting ---------------------------------------------------------
    def on_admission(self, matched_tokens: int):
        """Record one eligible admission's hit or miss (called by
        ``Scheduler.admit`` once the mapping is committed)."""
        if matched_tokens > 0:
            self.hits += 1
            self.hit_tokens += matched_tokens
            if self.metrics is not None:
                self.metrics.on_prefix_hit(matched_tokens)
        else:
            self.misses += 1
            if self.metrics is not None:
                self.metrics.on_prefix_miss()

    def on_cow(self):
        self.cow_copies += 1
        if self.metrics is not None:
            self.metrics.on_prefix_cow()

    def _publish_gauge(self):
        if self.metrics is not None:
            self.metrics.set_prefix_cached_tokens(self.cached_tokens)

    @property
    def num_pages(self) -> int:
        return len(self._by_page)

    @property
    def cached_tokens(self) -> int:
        """Tokens' worth of KV the index can currently serve."""
        return len(self._by_page) * self.page_size

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_stats(self):
        """Zero the hit/miss/evict/cow counters; the index keeps its
        pages."""
        self.hits = self.misses = self.hit_tokens = 0
        self.evictions = self.cow_copies = 0

    def stats(self) -> dict:
        out = {
            "enabled": True,
            "pages": self.num_pages,
            "cached_tokens": self.cached_tokens,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate(),
            "hit_tokens": self.hit_tokens,
            "evictions": self.evictions,
            "cow_copies": self.cow_copies,
        }
        if self.transport is not None:
            out["tiers"] = self.transport.stats()
        return out
