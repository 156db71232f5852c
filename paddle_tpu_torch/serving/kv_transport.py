"""Tiered KV page transport: host-RAM and disk tiers behind the prefix
cache — ``paddle_tpu/serving/kv_transport.py``'s twin.

Without tiers the prefix cache ends at the device's page pool: an
eviction discards KV that took real prefill work to produce, and a
later prompt with that prefix prefills it again.  Here an evicted page
survives off the card:

- **Demotion** — when ``PrefixCache`` evicts a refcount-0 leaf, the
  page's payload is copied device→host (the engine's gather closure)
  into a bounded host-RAM tier keyed by the TOKEN CHAIN that produced
  it.  The device page returns to the free list either way: tiering
  never changes the allocator, only where the payload goes.
- **Spill** — host-tier LRU overflow (and only overflow) goes to a DISK
  tier in ``io.checkpoint.CheckpointStore``'s CRC'd atomic slots.  A
  corrupt or torn disk entry is a MISS, never a wrong answer.
- **Promotion** — a radix walk that falls off the resident trie asks the
  tiers by chain key; a hit takes a free page, writes the payload back
  host→device in place (the engine's restore closure) and re-publishes
  the node, so the admission that follows maps it like a resident hit.

Timing: demotion and promotion run ONLY at admission (the engine opens
``demote_window`` around ``Scheduler.admit`` and promotes the waiting
prompts right before it); an eviction caused by decode-time page growth
discards, so steady decode never copies a page.

Chaos sites: ``kv.demote`` deny → the eviction discards (tier-off
behaviour); ``kv.promote`` deny → the lookup misses (re-prefill from
tokens).  Neither can corrupt a stream.

Threading: owned by the engine's driving thread, like the prefix cache
— no locks and no device calls (the engine injects its gather and
restore closures, so this module runs against numpy fakes in tests).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..framework.errors import InvalidArgumentError, PageTransportError
from ..profiler.flight_recorder import recorder as flight
from ..testing.chaos import chaos_site

__all__ = ["HostTier", "DiskTier", "PageTransport", "chain_key",
           "payload_nbytes"]

# one payload = ONE page's KV as host numpy arrays: {"k": [L x [P, H, D]],
# "v": [...]} plus "k_scale" / "v_scale" [H] rows in int8 modes, each in
# the pool's own dtype (a bfloat16 pool's pages as their int16 bit
# pattern: numpy has no bfloat16)
Payload = Dict[str, List[np.ndarray]]


def chain_key(tokens) -> Tuple[int, ...]:
    """Canonical tier key for a page: the FULL token chain from the
    prompt start through this page's last token.  Page content is a
    function of the whole chain, never of the page's own chunk alone —
    keying by chunk would alias two different prefixes onto one
    payload."""
    return tuple(int(t) for t in np.asarray(tokens).reshape(-1))


def _key_name(key: Tuple[int, ...]) -> str:
    """Filesystem-safe slot name for a chain key.  hashlib, not
    ``hash()``: the interpreter salts that per process, and tier slots
    must be findable across restarts."""
    digest = hashlib.sha1(
        np.asarray(key, np.int64).tobytes()).hexdigest()
    return f"kvpage-{digest}"


def payload_nbytes(payload: Payload) -> int:
    return int(sum(a.nbytes for arrs in payload.values() for a in arrs))


class HostTier:
    """Bounded LRU dict of page payloads in host RAM.

    ``put`` returns the entries LRU-evicted to make room (the
    PageTransport spills them to the disk tier or drops them); a
    re-``put`` of an existing key refreshes content and recency (equal
    content by the chain-key contract)."""

    def __init__(self, capacity_pages: int):
        if capacity_pages < 0:
            raise InvalidArgumentError(
                f"host tier capacity must be >= 0, got {capacity_pages}")
        self.capacity = int(capacity_pages)
        self._entries: "OrderedDict[Tuple[int, ...], Payload]" = \
            OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def put(self, key: Tuple[int, ...], payload: Payload
            ) -> List[Tuple[Tuple[int, ...], Payload]]:
        if self.capacity == 0:
            return [(key, payload)]
        self._entries[key] = payload
        self._entries.move_to_end(key)
        spilled = []
        while len(self._entries) > self.capacity:
            spilled.append(self._entries.popitem(last=False))
        return spilled

    def get(self, key: Tuple[int, ...]) -> Optional[Payload]:
        payload = self._entries.get(key)
        if payload is not None:
            self._entries.move_to_end(key)
        return payload

    def nbytes(self) -> int:
        return sum(payload_nbytes(p) for p in self._entries.values())


class DiskTier:
    """Very cold page payloads in a ``CheckpointStore`` (CRC'd atomic
    slots, one per page).  The chain key rides INSIDE the slot and is
    checked on load: a sha1 slot-name collision is a miss, like a torn
    write."""

    def __init__(self, store, capacity_pages: int):
        if capacity_pages < 0:
            raise InvalidArgumentError(
                f"disk tier capacity must be >= 0, got {capacity_pages}")
        self.store = store
        self.capacity = int(capacity_pages)
        # insertion-ordered key -> slot name (the LRU ring; recency is
        # write recency — disk promotions re-enter through the device)
        self._names: "OrderedDict[Tuple[int, ...], str]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._names)

    def put(self, key: Tuple[int, ...], payload: Payload):
        if self.capacity == 0:
            return
        state = dict(payload)
        state["_chain"] = np.asarray(key, np.int64)
        self.store.save_named(_key_name(key), state)
        self._names[key] = _key_name(key)
        self._names.move_to_end(key)
        while len(self._names) > self.capacity:
            _, name = self._names.popitem(last=False)
            self.store.delete_named(name)

    def get(self, key: Tuple[int, ...]) -> Optional[Payload]:
        if key not in self._names:
            return None
        got = self.store.load_named(self._names[key], return_numpy=True)
        if got is None:
            # torn or corrupt slot: a MISS, and the entry is retired so
            # the next demotion rewrites it clean
            self.store.delete_named(self._names.pop(key))
            return None
        state, _ = got
        chain = state.pop("_chain", None)
        if chain is None or chain_key(chain) != key:
            # a slot-name collision or a foreign slot: its content is
            # some OTHER prefix's
            return None
        return state


class PageTransport:
    """Demote / promote coordinator over the two tiers.

    ``gather_fn(page_ids) -> [payload per page]`` and
    ``restore_fn(page_ids, payloads)`` are the engine's closures over its
    page gather and in-place page write (numpy fakes in unit tests).
    ``chaos_key`` scopes fault schedules per replica, like the engine's
    own sites."""

    def __init__(self, gather_fn: Callable, restore_fn: Callable, *,
                 host_pages: int = 64, disk_store=None,
                 disk_pages: int = 0, metrics=None,
                 chaos_key: Optional[str] = None):
        if disk_pages and disk_store is None:
            # a truthy option must not silently do nothing
            raise InvalidArgumentError(
                "disk_pages > 0 requires a disk_store (an "
                "io.checkpoint.CheckpointStore directory for the spill "
                "tier)")
        self._gather = gather_fn
        self._restore = restore_fn
        self.host = HostTier(host_pages)
        self.disk = (DiskTier(disk_store, disk_pages)
                     if disk_store is not None else None)
        self.metrics = metrics
        self.chaos_key = chaos_key
        # admission window (engine-controlled): demotions copy device to
        # host, so they run only while the engine is at an admission
        # boundary — an eviction under decode-time page pressure
        # discards instead
        self.demote_window = False
        # plain counters mirrored into the metrics registry (stats()
        # works without a metrics object)
        self.demotions = 0
        self.promotions = 0
        self.demote_denied = 0
        self.disk_hits = 0

    # --- demotion (PrefixCache._drop_node) --------------------------------
    def demote(self, key: Tuple[int, ...], page_id: int) -> bool:
        """Copy ``page_id``'s payload into the host tier under ``key``
        BEFORE the allocator reclaims the page.  Returns False — the page
        is discarded as with tiers off — outside the admission window,
        under a chaos ``kv.demote`` denial, or when the gather fails; the
        caller releases the device page either way."""
        if not self.demote_window:
            self.demote_denied += 1
            return False
        fault = chaos_site("kv.demote", key=self.chaos_key)
        if fault is not None and fault.action == "deny":
            self.demote_denied += 1
            return False
        try:
            (payload,) = self._gather([int(page_id)])
        except Exception as e:  # noqa: BLE001 — degrade, never corrupt
            flight.on_transition("kv.demote_failed", str(page_id), str(e))
            self.demote_denied += 1
            return False
        for spill_key, spill_payload in self.host.put(key, payload):
            if self.disk is not None:
                self.disk.put(spill_key, spill_payload)
        self.demotions += 1
        if self.metrics is not None:
            self.metrics.on_prefix_demote()
        self._publish_gauges()
        return True

    # --- promotion (PrefixCache.promote_for) ------------------------------
    def fetch(self, key: Tuple[int, ...]) -> Optional[Payload]:
        """Tier lookup by chain key, host first, then disk; None is a
        MISS (the admission prefills from tokens — the same stream, only
        slower).  A disk hit is not put back into the host tier: the
        promoted page is device-resident, the hottest tier."""
        fault = chaos_site("kv.promote", key=self.chaos_key)
        if fault is not None and fault.action == "deny":
            return None
        payload = self.host.get(key)
        if payload is None and self.disk is not None:
            payload = self.disk.get(key)
            if payload is not None:
                self.disk_hits += 1
        return payload

    def restore_page(self, page_id: int, payload: Payload):
        """Write one promoted payload into the freshly taken device page
        (host→device through the engine's restore closure).  Raises
        PageTransportError on failure — the caller releases the page and
        treats the chain as a miss."""
        try:
            self._restore([int(page_id)], [payload])
        except Exception as e:
            raise PageTransportError(
                f"promotion restore of page {page_id} failed: {e}"
            ) from e
        self.promotions += 1
        if self.metrics is not None:
            self.metrics.on_prefix_promote()
        self._publish_gauges()

    # --- accounting -------------------------------------------------------
    def _publish_gauges(self):
        if self.metrics is not None:
            self.metrics.set_tier_pages(
                len(self.host), len(self.disk) if self.disk else 0)

    @property
    def host_pages(self) -> int:
        return len(self.host)

    @property
    def disk_pages(self) -> int:
        return len(self.disk) if self.disk is not None else 0

    def stats(self) -> dict:
        return {
            "enabled": True,
            "host_pages": self.host_pages,
            "host_capacity": self.host.capacity,
            "host_bytes": self.host.nbytes(),
            "disk_pages": self.disk_pages,
            "disk_capacity": (self.disk.capacity
                              if self.disk is not None else 0),
            "demotions": self.demotions,
            "promotions": self.promotions,
            "demote_denied": self.demote_denied,
            "disk_hits": self.disk_hits,
        }
