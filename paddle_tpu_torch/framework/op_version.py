"""Op version registry — twin of ``paddle_tpu/framework/op_version.py``
(the reference's op_version_registry.cc + the OpVersionMap of
framework.proto): each op records its schema-change checkpoints, so a
program saved by an older version can be checked on load.  The history
is the JAX package's, under the same op names."""
from __future__ import annotations

from typing import Dict, List, NamedTuple

__all__ = ["OpCheckpoint", "OpVersionRegistry", "op_version_registry"]


class OpCheckpoint(NamedTuple):
    note: str
    version: int


class OpVersionRegistry:
    """op name -> its ordered schema checkpoints."""

    def __init__(self):
        self._versions: Dict[str, List[OpCheckpoint]] = {}

    def register(self, op_name: str, note: str) -> "OpVersionRegistry":
        cps = self._versions.setdefault(op_name, [])
        cps.append(OpCheckpoint(note, len(cps) + 1))
        return self

    def version_of(self, op_name: str) -> int:
        """The current schema version (0: never changed)."""
        cps = self._versions.get(op_name)
        return cps[-1].version if cps else 0

    def checkpoints(self, op_name: str) -> List[OpCheckpoint]:
        return list(self._versions.get(op_name, []))

    def version_map(self) -> Dict[str, int]:
        """``{op: version}``, the map a saved program carries."""
        return {n: cps[-1].version for n, cps in self._versions.items()}

    def check_compat(self, saved_map: Dict[str, int]) -> List[str]:
        """The incompatibilities of a loaded program's version map with
        this registry, as messages."""
        problems = []
        for op, saved_v in saved_map.items():
            cur = self.version_of(op)
            if saved_v > cur:
                problems.append(
                    f"op {op!r}: program saved with schema v{saved_v}, this "
                    f"framework only knows v{cur} — upgrade the framework")
            elif saved_v < cur:
                notes = "; ".join(
                    c.note for c in self.checkpoints(op)[saved_v:])
                problems.append(
                    f"op {op!r}: schema changed since the program was saved "
                    f"(v{saved_v} -> v{cur}): {notes}")
        return problems


op_version_registry = OpVersionRegistry()

op_version_registry.register(
    "batch_norm", "training path fused into a custom-VJP op with "
    "pivot-shifted single-pass variance (round 3)")
op_version_registry.register(
    "dropout", "rng key became an op input (static-replay refresh) "
    "instead of a closure constant (round 2)")
