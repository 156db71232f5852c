"""Dataset engine for file-fed (CTR/PS) training — twin of
``paddle_tpu/distributed/fleet/dataset.py`` (host code on numpy, the same
records, shuffles and batches).

Reference: framework/data_set.h — Dataset/DatasetImpl (:43,157;
SetFileList :162, LoadIntoMemory :200, LocalShuffle :204, GlobalShuffle
:205, CreateReaders :210) and the python facade fluid/dataset.py
(DatasetFactory :26, InMemoryDataset :128, QueueDataset).

Shape: records parse via io.multislot (text MultiSlotDataFeed);
InMemoryDataset holds parsed records and shuffles them host-side;
GlobalShuffle exchanges records ACROSS TRAINER PROCESSES through the gloo
backend by hash bucketing (the reference routes through fleet send — same
semantics, records end up on a uniformly-random trainer, deterministic
given the seed).  Batches leave as padded numpy dicts ready for device
copies (LoD→padding delta documented in io/multislot.py)."""
from __future__ import annotations

import glob as _glob
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ...io.multislot import MultiSlotDataFeed, Record, Slot


class DatasetFactory:
    """fluid/dataset.py:26 — create_dataset('InMemoryDataset'|...)."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        try:
            return {"QueueDataset": QueueDataset,
                    "InMemoryDataset": InMemoryDataset}[datafeed_class]()
        except KeyError:
            raise ValueError(
                f"datafeed class {datafeed_class} does not exist")


class DatasetBase:
    """fluid/dataset.py:65 DatasetBase — config surface shared by queue/
    in-memory variants."""

    def __init__(self):
        self.thread_num = 1
        self.filelist: List[str] = []
        self.batch_size = 1
        self._slots: List[Slot] = []
        self._feed: Optional[MultiSlotDataFeed] = None
        self._pipe_command = "cat"
        self._drop_last = False

    # -- reference setters (fluid/dataset.py:78-258) --

    def set_pipe_command(self, pipe_command: str):
        # kept for API parity; the text parser reads files directly
        self._pipe_command = pipe_command

    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num: int):
        self.thread_num = max(1, int(thread_num))

    def set_filelist(self, filelist: Sequence[str]):
        files = []
        for f in filelist:
            hits = sorted(_glob.glob(f)) if any(c in f for c in "*?[") \
                else [f]
            files.extend(hits)
        self.filelist = files

    def set_use_var(self, var_list):
        """Derive slots from feed variables (reference set_use_var:228 reads
        each var's dtype/shape).  Accepts Slot objects directly or anything
        with .name/.dtype/.shape (InputSpec, static Variables)."""
        slots = []
        for v in var_list:
            if isinstance(v, Slot):
                slots.append(v)
                continue
            name = getattr(v, "name")
            dtype = str(getattr(v, "dtype", "int64"))
            dtype = "float32" if "float" in dtype else "int64"
            shape = list(getattr(v, "shape", []) or [])
            dense = dtype == "float32" or (len(shape) and shape[-1] > 1)
            dim = int(shape[-1]) if shape else 1
            slots.append(Slot(name, dtype=dtype, is_dense=dense,
                              dim=max(dim, 1)))
        self.set_slots(slots)

    def set_slots(self, slots: Sequence[Slot]):
        self._slots = list(slots)
        self._feed = MultiSlotDataFeed(self._slots)

    @property
    def slots(self):
        return list(self._slots)

    def _require_feed(self) -> MultiSlotDataFeed:
        if self._feed is None:
            raise RuntimeError(
                "dataset has no slots — call set_slots()/set_use_var() "
                "before loading")
        return self._feed

    def _batches_from_records(self, records: Sequence[Record]) \
            -> Iterator[Dict[str, np.ndarray]]:
        feed = self._require_feed()
        bs = self.batch_size
        for i in range(0, len(records), bs):
            chunk = records[i:i + bs]
            if self._drop_last and len(chunk) < bs:
                return
            yield feed.batch(chunk)


class QueueDataset(DatasetBase):
    """Streaming dataset (fluid/dataset.py QueueDataset / reference
    MultiSlotDataFeed channels): files are read lazily, split round-robin
    across trainer threads; nothing is retained."""

    def iter_batches(self, thread_id: int = 0,
                     num_threads: Optional[int] = None) \
            -> Iterator[Dict[str, np.ndarray]]:
        feed = self._require_feed()
        n = num_threads or self.thread_num
        buf: List[Record] = []
        for fi, path in enumerate(self.filelist):
            if fi % n != thread_id:
                continue
            for rec in feed.iter_file(path):
                buf.append(rec)
                if len(buf) == self.batch_size:
                    yield feed.batch(buf)
                    buf = []
        if buf and not self._drop_last:
            yield feed.batch(buf)


class InMemoryDataset(DatasetBase):
    """data_set.h:157 InMemoryDataset: LoadIntoMemory + Local/GlobalShuffle
    over parsed records."""

    def __init__(self):
        super().__init__()
        self._records: List[Record] = []
        self._loaded = False
        self._shuffle_seed = 0
        self._shuffle_rng: Optional[np.random.RandomState] = None

    # -- lifecycle (data_set.h:200-205; fluid/dataset.py:676-820) --

    def load_into_memory(self):
        feed = self._require_feed()
        self._records = []
        for path in self.filelist:
            self._records.extend(feed.read_file(path))
        self._loaded = True

    def preload_into_memory(self, thread_num=None):
        # reference PreLoadIntoMemory is async; loading here is fast enough
        # to stay synchronous — wait_preload_done is then a no-op
        self.load_into_memory()

    def wait_preload_done(self):
        return None

    def set_shuffle_seed(self, seed: int):
        """fleet's dataset sets this before global_shuffle so every trainer
        permutes consistently.  Resets the shuffle stream."""
        self._shuffle_seed = int(seed)
        self._shuffle_rng = None

    def _rng(self) -> np.random.RandomState:
        # one ADVANCING stream per dataset: successive shuffles (one per
        # epoch is the standard CTR loop) give different permutations while
        # staying deterministic from the seed
        if self._shuffle_rng is None:
            self._shuffle_rng = np.random.RandomState(self._shuffle_seed)
        return self._shuffle_rng

    def local_shuffle(self):
        """data_set.h:204 — in-place permutation of this trainer's records."""
        perm = self._rng().permutation(len(self._records))
        self._records = [self._records[i] for i in perm]

    def set_fea_eval(self, record_candidate_size: int, fea_eval: bool = True):
        """fluid/dataset.py:113 — enable slots_shuffle (feature-importance
        eval mode); candidate size bounds the shuffle pool."""
        self._fea_eval = bool(fea_eval)
        self._fea_candidate_size = int(record_candidate_size)

    def slots_shuffle(self, slots):
        """fluid/dataset.py:136 / data_set.h SlotsShuffle: permute the
        VALUES of the named slots ACROSS records (labels and other slots
        stay put) — evaluating a feature's importance by destroying its
        alignment.  Requires set_fea_eval(..., True)."""
        if not getattr(self, "_fea_eval", False):
            raise RuntimeError(
                "slots_shuffle requires set_fea_eval(record_candidate_size,"
                " True) first (reference dataset.py:150)")
        if not self._loaded:
            raise RuntimeError("call load_into_memory() first")
        rng = self._rng()
        n = min(len(self._records),
                getattr(self, "_fea_candidate_size", len(self._records)))
        pool = list(range(n))
        for slot_name in slots:
            perm = rng.permutation(n)
            vals = [self._records[i].slots[slot_name] for i in pool]
            for dst, src in zip(pool, perm):
                self._records[dst].slots[slot_name] = vals[src]

    def global_shuffle(self, fleet=None, thread_num: int = -1):
        """data_set.h:205 — shuffle records ACROSS trainers: every record is
        routed to a uniformly-random trainer (hash bucketing over the gloo
        backend), then locally shuffled.  Single-process (or no backend)
        collapses to local_shuffle, matching the reference behavior with one
        trainer."""
        from .. import gloo
        from ..env import get_rank, get_world_size

        world = get_world_size()
        be = gloo.get_backend()
        if world <= 1 or be is None:
            self.local_shuffle()
            return
        # every trainer must draw DIFFERENT destinations for its own records
        # but deterministically: fold the rank into the stream
        rng = np.random.RandomState(
            (self._shuffle_seed * 1000003 + get_rank()) % (2 ** 31))
        dest = rng.randint(0, world, size=len(self._records))
        buckets = [[] for _ in range(world)]
        for rec, d in zip(self._records, dest):
            buckets[d].append(rec.slots)
        # all_gather: everyone posts its per-destination buckets, takes the
        # slices addressed to itself
        all_buckets = be.all_gather(buckets, group_id=0)
        mine: List[Record] = []
        for sender_buckets in all_buckets:
            mine.extend(Record(s) for s in sender_buckets[get_rank()])
        self._records = mine
        self.local_shuffle()

    def release_memory(self):
        self._records = []
        self._loaded = False

    def get_memory_data_size(self, fleet=None) -> int:
        return len(self._records)

    def get_shuffle_data_size(self, fleet=None) -> int:
        return len(self._records)

    # -- consumption --

    def iter_batches(self, thread_id: int = 0,
                     num_threads: Optional[int] = None) \
            -> Iterator[Dict[str, np.ndarray]]:
        """Shard records contiguously across trainer threads (reference
        CreateReaders splits channels per thread)."""
        if not self._loaded:
            raise RuntimeError("call load_into_memory() first")
        n = num_threads or self.thread_num
        yield from self._batches_from_records(self._records[thread_id::n])


class MultiSlotDataGenerator:
    """reference fleet MultiSlotDataGenerator (data_generator.py): user
    subclasses implement generate_sample(line); run() streams the
    MultiSlot text protocol to stdout for dataset pipes."""

    def __init__(self):
        self._proto_info = None

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def generate_sample(self, line):
        raise NotImplementedError(
            "subclass MultiSlotDataGenerator and implement "
            "generate_sample(line) -> iterator of (name, values) lists")

    def generate_batch(self, samples):
        for s in samples:
            yield s

    def _format(self, sample):
        parts = []
        for name, values in sample:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts)

    def run_from_stdin(self):
        import sys

        for line in sys.stdin:
            for sample in self.generate_sample(line):
                sys.stdout.write(self._format(sample) + "\n")

    run = run_from_stdin
