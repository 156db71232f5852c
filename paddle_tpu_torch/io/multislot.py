"""Multi-slot text DataFeed: the industrial CTR input format — twin of
``paddle_tpu/io/multislot.py`` (host code on numpy, the same parser).

Reference: framework/data_feed.h:664 MultiSlotDataFeed — "The format of
multi-slot type data: [n feasign_0 feasign_1 ... feasign_n]*": each line
holds, for every declared slot in order, a count followed by that many
values; uint64 feasigns for sparse slots, floats for dense slots
(data_feed.proto Slot{name,type,is_dense,is_used}).

Batch layout: the reference carries ragged slots as LoDTensors; the JAX
package (XLA has no ragged shapes) batches sparse slots to a PADDED
[B, L] int64 matrix (L = longest instance in the batch, pad id = -1) —
mask with ``ids >= 0`` — and the port keeps that layout.  Dense slots
batch to [B, dim] float32.  This is the LoD→padding design delta
documented in SURVEY §7."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence

import numpy as np

PAD_ID = -1


@dataclass
class Slot:
    """One slot of the feed (data_feed.proto Slot analog)."""
    name: str
    dtype: str = "int64"       # "int64" (sparse feasigns) | "float32"
    is_dense: bool = False
    dim: int = 1               # expected count for dense slots

    def __post_init__(self):
        if self.dtype not in ("int64", "float32"):
            raise ValueError(f"slot dtype must be int64/float32, "
                             f"got {self.dtype!r}")


class Record:
    """One parsed instance: per-slot value arrays (data_feed.h Record
    analog — uint64_feasigns_/float_feasigns_ keyed by slot here)."""

    __slots__ = ("slots",)

    def __init__(self, slots: Dict[str, np.ndarray]):
        self.slots = slots


class MultiSlotDataFeed:
    """Text parser for the multi-slot format (MultiSlotDataFeed::
    ParseOneInstance analog, vectorized over whole files with numpy)."""

    def __init__(self, slots: Sequence[Slot]):
        if not slots:
            raise ValueError("at least one slot required")
        self.slots = list(slots)

    def parse_line(self, line: str) -> Record:
        toks = line.split()
        out = {}
        pos = 0
        for s in self.slots:
            if pos >= len(toks):
                raise ValueError(
                    f"line ended before slot {s.name!r} "
                    f"(format: [n v1..vn] per slot)")
            n = int(toks[pos])
            pos += 1
            vals = toks[pos:pos + n]
            if len(vals) != n:
                raise ValueError(
                    f"slot {s.name!r} declares {n} values, "
                    f"line has {len(vals)}")
            pos += n
            if s.dtype == "int64":
                out[s.name] = np.asarray(vals, np.int64)
            else:
                out[s.name] = np.asarray(vals, np.float32)
            if s.is_dense and n != s.dim:
                raise ValueError(
                    f"dense slot {s.name!r} expects dim {s.dim}, got {n}")
        if pos != len(toks):
            raise ValueError(
                f"{len(toks) - pos} trailing tokens after last slot")
        return Record(out)

    def read_file(self, path: str) -> List[Record]:
        """CheckFile+ReadThread analog: parse a whole file."""
        records = []
        with open(path, "r") as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(self.parse_line(line))
                except ValueError as e:
                    raise ValueError(f"{path}:{ln}: {e}") from e
        return records

    def iter_file(self, path: str) -> Iterator[Record]:
        """Streaming form (QueueDataset path — no in-memory copy)."""
        with open(path, "r") as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    yield self.parse_line(line)
                except ValueError as e:
                    raise ValueError(f"{path}:{ln}: {e}") from e

    def batch(self, records: Sequence[Record]) -> Dict[str, np.ndarray]:
        """PutToFeedVec analog: assemble one batch.

        sparse slot -> [B, L_max] int64 padded with PAD_ID (=-1)
        dense slot  -> [B, dim]  float32
        """
        out = {}
        for s in self.slots:
            vals = [r.slots[s.name] for r in records]
            if s.is_dense:
                out[s.name] = np.stack(vals).astype(
                    np.float32 if s.dtype == "float32" else np.int64)
                continue
            if s.dtype == "float32":
                # ragged float slot: pad with 0.0 + parallel mask
                L = max(len(v) for v in vals)
                m = np.zeros((len(vals), L), np.float32)
                for i, v in enumerate(vals):
                    m[i, :len(v)] = v
                out[s.name] = m
            else:
                L = max(len(v) for v in vals)
                m = np.full((len(vals), L), PAD_ID, np.int64)
                for i, v in enumerate(vals):
                    m[i, :len(v)] = v
                out[s.name] = m
        return out


def write_multislot_file(path: str, rows: Sequence[Dict[str, Sequence]],
                         slots: Sequence[Slot]) -> None:
    """Serialize instances back to the text format (test/data-gen helper —
    the reference's incubate/data_generator writes the same shape)."""
    with open(path, "w") as f:
        for row in rows:
            parts = []
            for s in slots:
                vals = row[s.name]
                parts.append(str(len(vals)))
                parts.extend(str(v) for v in vals)
            f.write(" ".join(parts) + "\n")
