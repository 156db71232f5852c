"""Block-paged KV-cache manager (host side) — ``PagedKVCache`` from
``paddle_tpu/serving/kv_cache.py``.

The device side is a pair of global page pools per layer
(``[num_pages, page_size, H, D]`` tensors, owned by the engine and
updated in place by the serving step); this module owns the host
bookkeeping — which physical page belongs to which sequence — as plain
Python, so allocation never touches the device.

Page id 0 is RESERVED as the trash page: it is never allocated, padding
entries of every page-table row point at it, and masked/inactive rows
scatter into it.  Every page-table entry is therefore a valid index and
the attention kernel needs no bounds checks.

Allocation is a LIFO free list.  Pages carry a reference count — the
number of sequence tables that contain them — so ``share`` can map one
resident page into several tables and ``free`` only DECREFS.  Pages the
prefix index holds (``pin_cached``) stay RESIDENT at refcount 0 —
evictable, not free: ``allocate`` reclaims them through the registered
reclaimer (the index's LRU eviction) only when the free list runs short.
``cow_page`` is the host half of copy-on-write: it swaps a shared page
in a sequence's table for a fresh one, and the engine copies the payload
on the device.  ``pages_in_use`` counts distinct referenced pages,
``pages_cached`` the refcount-0 resident ones, and ``pages_in_use +
pages_cached + free_pages == allocatable_pages`` always holds (the leak
invariant).

Int8 pages (the quantized serving arm) keep one fp32 scale per (page,
head) beside the int8 payload, so a page costs ``P * H * D`` bytes plus
``4 * H``.  ``quantize_kv_page`` / ``dequantize_kv_page`` are the numpy
reference for that layout (symmetric, zero-point-free, qmax 127); the
device write path lives in ``text/generation.py`` and the dequant in the
attention kernel.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..framework.errors import InvalidArgumentError
from ..testing.chaos import chaos_site

__all__ = ["PagedKVCache", "KV_SCALE_EPS", "kv_page_bytes",
           "quantize_kv_page", "dequantize_kv_page"]

# floor for per-page scales: keeps ratio math finite on never-written
# pages (dynamic mode initializes scales to this)
KV_SCALE_EPS = 1e-8

_KV_ITEMSIZE = {"int8": 1, "bfloat16": 2, "bf16": 2, "float16": 2,
                "fp16": 2, "float32": 4, "fp32": 4}


def kv_page_bytes(page_size: int, num_heads: int, head_dim: int,
                  dtype: str = "bfloat16") -> int:
    """Bytes one K **or** V page occupies on device, including its
    per-page-per-head fp32 scale row when int8."""
    try:
        itemsize = _KV_ITEMSIZE[str(dtype)]
    except KeyError:
        raise InvalidArgumentError(
            f"unknown KV cache dtype {dtype!r}; one of "
            f"{sorted(_KV_ITEMSIZE)}")
    n = page_size * num_heads * head_dim * itemsize
    if itemsize == 1:
        n += num_heads * 4            # fp32 scale per head
    return n


def quantize_kv_page(page: np.ndarray, scales: Optional[np.ndarray] = None):
    """Numpy reference for the device write path: quantize one [P, H, D]
    float page to (int8 page, [H] fp32 scales).

    ``scales=None`` derives per-head abs-max scales from the page itself
    (what the dynamic write path converges to once every slot is
    written); passing calibrated scales reproduces the static path
    (values CLIP at ±127 instead of rescaling).
    """
    page = np.asarray(page, np.float32)
    if scales is None:
        amax = np.abs(page).max(axis=(0, 2))          # [H]
        scales = np.maximum(amax / 127.0, KV_SCALE_EPS)
    scales = np.asarray(scales, np.float32)
    q = np.clip(np.round(page / scales[None, :, None]), -127, 127)
    return q.astype(np.int8), scales


def dequantize_kv_page(qpage: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of ``quantize_kv_page``: [P, H, D] int8 + [H] scales →
    f32 (round-trip error ≤ scale/2 per element)."""
    return qpage.astype(np.float32) * np.asarray(
        scales, np.float32)[None, :, None]


class PagedKVCache:
    """Free-list page allocator + per-sequence page tables."""

    def __init__(self, num_pages: int, page_size: int, pages_per_seq: int,
                 reserved_pages: Tuple[int, ...] = (0,)):
        if num_pages < 2:
            raise InvalidArgumentError(
                "num_pages must be >= 2 (page 0 is the "
                "reserved trash page)")
        if page_size < 1 or pages_per_seq < 1:
            raise InvalidArgumentError(
                "page_size and pages_per_seq must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        reserved = {0} | {int(p) for p in reserved_pages}
        for p in sorted(reserved):
            if not (0 <= p < self.num_pages):
                raise InvalidArgumentError(
                    f"reserved page id {p} out of range "
                    f"(0..{self.num_pages - 1})")
        if len(reserved) >= self.num_pages:
            raise InvalidArgumentError(
                "reserved_pages leaves no allocatable pages")
        self.reserved_pages: Tuple[int, ...] = tuple(sorted(reserved))
        # LIFO free list; reserved pages excluded (trash rows)
        self._free: List[int] = [p for p in
                                 range(self.num_pages - 1, 0, -1)
                                 if p not in reserved]
        self._tables: Dict[str, List[int]] = {}
        # page id -> number of sequence tables containing it
        self._ref: Dict[int, int] = {}
        # pages the prefix index holds resident: at refcount 0 they are
        # EVICTABLE (reclaimed through the reclaimer), never free
        self._cached: set = set()
        # the prefix cache's LRU eviction: called with the page deficit
        # when the free list cannot cover an allocation
        self._reclaimer: Optional[Callable[[int], int]] = None
        self.total_allocs = 0
        self.total_frees = 0
        self.total_shared_maps = 0
        self.total_cow = 0
        self.peak_pages_in_use = 0

    # --- capacity ---------------------------------------------------------
    def pages_needed(self, num_tokens: int) -> int:
        """Pages covering ``num_tokens`` KV positions."""
        return max(0, -(-int(num_tokens) // self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocatable_pages(self) -> int:
        """``num_pages`` minus the reserved trash rows — the leak
        invariant closes over this: ``pages_in_use + pages_cached +
        free_pages == allocatable_pages``."""
        return self.num_pages - len(self.reserved_pages)

    @property
    def pages_in_use(self) -> int:
        """Distinct pages referenced by >= 1 sequence (a shared page
        counts once)."""
        return len(self._ref)

    @property
    def pages_cached(self) -> int:
        """Resident refcount-0 pages held only by the prefix index
        (evictable on demand — neither leaked nor free)."""
        return sum(1 for p in self._cached if p not in self._ref)

    def ref_count(self, page_id: int) -> int:
        return self._ref.get(int(page_id), 0)

    def is_free(self, page_id: int) -> bool:
        """True when the page is on the free list: no sequence holds it
        and no prefix index keeps it resident — the quarantine scrub
        zeroes only such pages (a page shared with other readers keeps
        its clean payload)."""
        p = int(page_id)
        return self._ref.get(p, 0) == 0 and p not in self._cached

    def num_seqs(self) -> int:
        return len(self._tables)

    def seq_pages(self, seq_id: str) -> int:
        return len(self._tables.get(seq_id, ()))

    def allocated_tokens(self, seq_id: str) -> int:
        """KV positions ``seq_id``'s current page table can hold —
        writes at positions >= this land in the trash page (the
        spec-decode junk-containment boundary)."""
        return self.seq_pages(seq_id) * self.page_size

    # --- allocation -------------------------------------------------------
    def allocate(self, seq_id: str, num_tokens: int) -> bool:
        """Grow ``seq_id``'s page table to cover ``num_tokens`` positions.

        All-or-nothing: returns False (no state change) when the free
        list cannot supply the growth or the sequence would exceed
        ``pages_per_seq`` — the scheduler then preempts or queues.

        Chaos site ``kv.allocate`` (action ``deny``): simulated transient
        page exhaustion."""
        fault = chaos_site("kv.allocate", key=seq_id)
        if fault is not None and fault.action == "deny":
            return False
        table = self._tables.get(seq_id)
        have = len(table) if table is not None else 0
        need = self.pages_needed(num_tokens) - have
        if need <= 0:
            return True
        if have + need > self.pages_per_seq:
            return False
        if need > len(self._free):
            self._reclaim(need - len(self._free))
        if need > len(self._free):
            # no phantom registration on failure
            return False
        if table is None:
            table = self._tables[seq_id] = []
        for _ in range(need):
            page = self._free.pop()
            table.append(page)
            self._ref[page] = 1
        self.total_allocs += need
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)
        return True

    def _reclaim(self, deficit: int):
        """Ask the prefix index (if attached) to evict refcount-0 cached
        pages back to the free list — cached prefixes yield to live
        sequences before an allocation fails or preemption strikes."""
        if self._reclaimer is not None and deficit > 0:
            self._reclaimer(deficit)

    def set_reclaimer(self, fn: Optional[Callable[[int], int]]):
        """Register the cached-page eviction hook (the prefix cache
        attaches itself here)."""
        self._reclaimer = fn

    def _release_ref(self, page: int):
        """Drop one reference; a page reaching refcount 0 returns to the
        free list unless the prefix index holds it resident."""
        n = self._ref.get(page, 0) - 1
        if n > 0:
            self._ref[page] = n
            return
        self._ref.pop(page, None)
        if page not in self._cached:
            self._free.append(page)

    def free(self, seq_id: str) -> int:
        """Drop all of ``seq_id``'s page references; returns the table
        length.  Shared pages only decref."""
        table = self._tables.pop(seq_id, None)
        if not table:
            return 0
        for page in reversed(table):
            self._release_ref(page)
        self.total_frees += len(table)
        return len(table)

    # --- prefix sharing / copy-on-write ------------------------------------
    def share(self, seq_id: str, page_ids: List[int]) -> bool:
        """Map already-resident ``page_ids`` (a radix-index match) as the
        HEAD of a new sequence's table, increffing each — before the
        sequence's first ``allocate``.  Returns False untouched when the
        sequence already has a table or the prefix alone would exceed
        ``pages_per_seq``."""
        if not page_ids:
            return True
        if seq_id in self._tables or len(page_ids) > self.pages_per_seq:
            return False
        for page in page_ids:
            if int(page) in self.reserved_pages:
                raise InvalidArgumentError(
                    f"shared page id {page} is reserved (a trash page)")
            if int(page) not in self._ref and int(page) not in self._cached:
                raise InvalidArgumentError(
                    f"shared page id {page} is not resident")
        self._tables[seq_id] = [int(p) for p in page_ids]
        for page in self._tables[seq_id]:
            self._ref[page] = self._ref.get(page, 0) + 1
        self.total_shared_maps += len(page_ids)
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)
        return True

    def cow_page(self, seq_id: str,
                 table_index: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write, host half: replace the shared page at
        ``table_index`` of ``seq_id``'s table with a freshly allocated
        private page and decref the original.  Returns ``(src, dst)`` for
        the engine's device copy, or None (state untouched — the caller
        defers the admission) when no page can be had.

        Goes through the chaos site ``kv.allocate`` like every other
        allocation: a ``deny`` defers the copy exactly like exhaustion."""
        fault = chaos_site("kv.allocate", key=seq_id)
        if fault is not None and fault.action == "deny":
            return None
        table = self._tables.get(seq_id)
        if table is None or not (0 <= table_index < len(table)):
            raise InvalidArgumentError(
                f"cow_page: sequence {seq_id!r} has no page at table "
                f"index {table_index}")
        if not self._free:
            self._reclaim(1)
        if not self._free:
            return None
        src = table[table_index]
        dst = self._free.pop()
        table[table_index] = dst
        self._ref[dst] = 1
        self._release_ref(src)
        self.total_allocs += 1
        self.total_cow += 1
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)
        return src, dst

    # --- prefix-index residency (called by serving.prefix_cache) ----------
    def pin_cached(self, page_id: int):
        """The prefix index took custody of ``page_id``: keep it resident
        (evictable, not free) when its refcount drops to 0."""
        self._cached.add(int(page_id))

    def release_cached(self, page_id: int):
        """The prefix index let go of ``page_id``: a refcount-0 page
        returns to the free list; a referenced one only loses its
        residency (it frees normally when its readers finish)."""
        page_id = int(page_id)
        self._cached.discard(page_id)
        if page_id not in self._ref:
            self._free.append(page_id)

    def take_cached_page(self) -> Optional[int]:
        """Pop one FREE page straight into cached residency (free to
        cached in one move, so the leak invariant never sees a middle
        state); None when the free list is empty — it never reclaims."""
        if not self._free:
            return None
        page = self._free.pop()
        self._cached.add(page)
        return page

    # --- page-table export ------------------------------------------------
    def seq_page_ids(self, seq_id: str) -> List[int]:
        """The physical page ids ``seq_id`` currently owns, in order."""
        return list(self._tables.get(seq_id, ()))

    def page_table_row(self, seq_id: str) -> np.ndarray:
        """[pages_per_seq] int32 row, padded with the trash page (0)."""
        row = np.zeros((self.pages_per_seq,), np.int32)
        table = self._tables.get(seq_id, ())
        row[: len(table)] = table
        return row

    # --- observability ----------------------------------------------------
    def stats(self, seq_lens: Optional[Dict[str, int]] = None) -> dict:
        """Allocator stats; pass live ``{seq_id: valid_len}`` to also get
        internal fragmentation (allocated slots minus used slots)."""
        out = {
            "num_pages": self.allocatable_pages,
            "page_size": self.page_size,
            "pages_in_use": self.pages_in_use,
            "pages_cached": self.pages_cached,
            "pages_free": self.free_pages,
            "num_seqs": self.num_seqs(),
            "total_allocs": self.total_allocs,
            "total_frees": self.total_frees,
            "total_shared_maps": self.total_shared_maps,
            "total_cow": self.total_cow,
            "peak_pages_in_use": self.peak_pages_in_use,
            "utilization": self.pages_in_use / max(self.allocatable_pages,
                                                   1),
        }
        if seq_lens is not None:
            out["internal_fragmentation_slots"] = sum(
                len(table) * self.page_size - int(seq_lens.get(sid, 0))
                for sid, table in self._tables.items())
        return out
