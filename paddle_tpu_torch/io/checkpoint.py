"""Atomic, manifest-verified checkpoint store — the twin of
``paddle_tpu/io/checkpoint.py``.

A :class:`CheckpointStore` commits **atomically** (write-to-temp + fsync
+ rename via ``framework_io.atomic_write_bytes``), is **self-validating**
(a manifest carrying a versioned schema, a whole-payload CRC and
per-leaf CRCs rides inside every checkpoint file) and **self-pruning**
(keep-last-K retention over step checkpoints).  The serving frontend's
``snapshot_store`` persists request snapshots in its named slots.

On-disk format — one file per checkpoint, byte-compatible with the JAX
package's store (a slot written by either loads in the other)::

    ckpt-0000000042.ckpt           step checkpoints (retention-managed)
    slot-<name>.ckpt               named slots (serving request snapshots
                                   — replace-in-place, exempt from step
                                   retention)

    file := MAGIC (8 bytes, b"PTCKPT1\\n")
            manifest length (4 bytes, big-endian)
            manifest JSON   {schema, step|name, payload_crc32,
                             payload_bytes, leaves: {path: {crc32, bytes,
                             dtype, shape}}, metadata, created_unix}
            payload         framework_io pickle of the state tree

Failure model:

- a kill at ANY instant of ``save`` (the deterministic ``ckpt.write``
  chaos sites ``temp`` / ``rename`` model each injection point) leaves
  the destination either absent or a previous complete commit — never
  torn;
- ``load(step)`` of a torn/corrupt/truncated file raises
  :class:`~paddle_tpu_torch.framework.errors.CheckpointCorruptError`; a
  manifest schema NEWER than this build raises
  :class:`~paddle_tpu_torch.framework.errors.CheckpointIncompatibleError`;
- ``load_latest()`` validates newest-first and FALLS BACK past corrupt
  or incompatible entries to the newest valid one, recording what it
  skipped in ``last_skipped`` (``load_named`` records a corrupt slot
  there and returns None).
"""
from __future__ import annotations

import json
import os
import re
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework.errors import (CheckpointCorruptError,
                                CheckpointIncompatibleError,
                                InvalidArgumentError)
from ..framework_io import (atomic_write_bytes, deserialize_bytes,
                            serialize_bytes)

__all__ = ["CheckpointStore", "SCHEMA_VERSION", "leaf_checksums"]

SCHEMA_VERSION = 1
_MAGIC = b"PTCKPT1\n"
_STEP_RE = re.compile(r"^ckpt-(\d{10})\.ckpt$")
_SLOT_RE = re.compile(r"^slot-(.+)\.ckpt$")


def _leaves(obj, path: str, out: Dict[str, np.ndarray]):
    """Flatten a state tree into {path: numpy leaf}.  Dict/list/tuple
    nest; paddle and torch tensors coerce through numpy (host copies);
    scalars/strings are checksummed via their repr bytes."""
    if isinstance(obj, dict):
        for k in obj:
            _leaves(obj[k], f"{path}/{k}" if path else str(k), out)
        return
    if isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _leaves(v, f"{path}/{i}" if path else str(i), out)
        return
    if hasattr(obj, "_value"):          # paddle Tensor
        obj = obj._value
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    try:
        arr = np.asarray(obj)
        if arr.dtype == object:         # reprs are stable, pointers not
            raise TypeError
    except Exception:
        arr = np.frombuffer(repr(obj).encode(), np.uint8)
    out[path] = arr


def leaf_checksums(state) -> Dict[str, dict]:
    """Per-leaf integrity records for the manifest: CRC32 of the leaf's
    raw bytes plus its dtype/shape — enough to point a corruption report
    at the exact parameter instead of "the file"."""
    flat: Dict[str, np.ndarray] = {}
    _leaves(state, "", flat)
    return {
        path: {"crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
               "bytes": int(arr.nbytes), "dtype": str(arr.dtype),
               "shape": list(arr.shape)}
        for path, arr in flat.items()
    }


class CheckpointStore:
    """Crash-consistent checkpoint directory.

    ``save(state, step)`` / ``load_latest()`` are the training surface
    (step-indexed, keep-last-``keep_last`` retention);
    ``save_named(name, state)`` / ``load_named(name)`` are the slot
    surface (serving request snapshots — replaced in place, exempt from
    retention).  All four commit/validate through the same atomic
    writer and manifest format.
    """

    def __init__(self, directory: str, keep_last: int = 3,
                 fsync: bool = True):
        if keep_last < 1:
            raise InvalidArgumentError(
                f"keep_last must be >= 1, got {keep_last}")
        self.directory = str(directory)
        self.keep_last = int(keep_last)
        self.fsync = bool(fsync)
        # (path, reason) entries the last load_latest() skipped over
        self.last_skipped: List[Tuple[str, str]] = []
        # tmp-dropping sweep throttle: a full listdir+stat scan on
        # EVERY save would be paid per request snapshot, which serving
        # stores commit many times a second
        self._last_sweep = 0.0
        self._sweeps = 0
        os.makedirs(self.directory, exist_ok=True)

    # --- paths --------------------------------------------------------------
    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{int(step):010d}.ckpt")

    def _slot_path(self, name: str) -> str:
        if not re.match(r"^[A-Za-z0-9._-]+$", name):
            raise InvalidArgumentError(
                f"slot name {name!r} must be filesystem-safe "
                "([A-Za-z0-9._-]+)")
        return os.path.join(self.directory, f"slot-{name}.ckpt")

    def steps(self) -> List[int]:
        """Committed step checkpoints, ascending (tmp droppings and
        foreign files are invisible)."""
        out = []
        for fn in sorted(os.listdir(self.directory)):
            m = _STEP_RE.match(fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def named(self) -> List[str]:
        out = []
        for fn in sorted(os.listdir(self.directory)):
            m = _SLOT_RE.match(fn)
            if m:
                out.append(m.group(1))
        return sorted(out)

    # --- commit -------------------------------------------------------------
    def _encode(self, state, manifest_extra: dict) -> bytes:
        payload = serialize_bytes(state)
        manifest = {
            "schema": SCHEMA_VERSION,
            "payload_crc32": zlib.crc32(payload),
            "payload_bytes": len(payload),
            "leaves": leaf_checksums(state),
            "created_unix": time.time(),
        }
        manifest.update(manifest_extra)
        mbytes = json.dumps(manifest, sort_keys=True).encode()
        return (_MAGIC + len(mbytes).to_bytes(4, "big") + mbytes + payload)

    def save(self, state, step: int, metadata: Optional[dict] = None) -> str:
        """Atomically commit ``state`` as the checkpoint for ``step``,
        then apply keep-last retention.  Returns the committed path.
        A crash anywhere inside leaves previous commits untouched."""
        path = self.path_for(step)
        data = self._encode(state, {"step": int(step),
                                    "metadata": metadata or {}})
        atomic_write_bytes(path, data, fsync=self.fsync)
        self._retain()
        return path

    def save_named(self, name: str, state,
                   metadata: Optional[dict] = None) -> str:
        """Atomically commit (or replace) the named slot ``name``."""
        path = self._slot_path(name)
        data = self._encode(state, {"name": name,
                                    "metadata": metadata or {}})
        atomic_write_bytes(path, data, fsync=self.fsync)
        # slot-only stores (the serving snapshot_store) never call
        # save() — sweep crashed writers' droppings here too
        self._sweep_tmp()
        return path

    def _retain(self):
        steps = self.steps()
        for step in steps[: -self.keep_last]:
            try:
                os.remove(self.path_for(step))
            except OSError:
                pass                     # already gone — retention races
        self._sweep_tmp()

    def _sweep_tmp(self, max_age_s: float = 3600.0,
                   min_interval_s: float = 60.0, force: bool = False):
        """Remove stray ``*.ckpt.tmp.*`` droppings from crashed
        writers, once they are older than any live commit attempt
        could be.  Throttled to at most one directory scan per
        ``min_interval_s`` (droppings only need max_age_s to pass
        before they are ELIGIBLE, so scanning on every commit bought
        nothing — the first sweep after the interval collects exactly
        the same set); ``force=True`` bypasses the throttle (tests,
        explicit maintenance)."""
        now = time.time()
        if not force and now - self._last_sweep < min_interval_s:
            return
        self._last_sweep = now
        self._sweeps += 1
        for fn in sorted(os.listdir(self.directory)):
            if ".ckpt.tmp." in fn:
                full = os.path.join(self.directory, fn)
                try:
                    if time.time() - os.path.getmtime(full) > max_age_s:
                        os.remove(full)
                except OSError:
                    pass

    # --- load / validate ----------------------------------------------------
    def _read(self, path: str) -> Tuple[dict, bytes]:
        """Parse + validate one checkpoint file.  Raises
        CheckpointCorruptError / CheckpointIncompatibleError."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise CheckpointCorruptError(f"{path}: unreadable ({e})")
        if len(blob) < len(_MAGIC) + 4 or not blob.startswith(_MAGIC):
            raise CheckpointCorruptError(
                f"{path}: bad magic / truncated header (torn write?)")
        mlen = int.from_bytes(blob[len(_MAGIC): len(_MAGIC) + 4], "big")
        mstart = len(_MAGIC) + 4
        try:
            manifest = json.loads(blob[mstart: mstart + mlen].decode())
        except Exception:
            raise CheckpointCorruptError(
                f"{path}: manifest JSON unparseable (torn write?)")
        schema = int(manifest.get("schema", -1))
        if schema > SCHEMA_VERSION:
            raise CheckpointIncompatibleError(
                f"{path}: manifest schema {schema} is newer than this "
                f"build's {SCHEMA_VERSION} — refusing a lossy restore")
        payload = blob[mstart + mlen:]
        if len(payload) != int(manifest.get("payload_bytes", -1)):
            raise CheckpointCorruptError(
                f"{path}: payload is {len(payload)} bytes, manifest "
                f"promises {manifest.get('payload_bytes')} (partial "
                "write)")
        if zlib.crc32(payload) != int(manifest.get("payload_crc32", -1)):
            raise CheckpointCorruptError(
                f"{path}: payload CRC mismatch (corrupt)")
        return manifest, payload

    def manifest(self, step: int) -> dict:
        manifest, _ = self._read(self.path_for(step))
        return manifest

    def load(self, step: Optional[int] = None, path: Optional[str] = None,
             return_numpy: bool = False,
             verify: bool = False) -> Tuple[Any, dict]:
        """Load + validate one specific checkpoint; raises on any
        integrity problem (use ``load_latest`` for fall-back
        semantics).  ``verify=True`` additionally re-checksums EVERY
        leaf of the deserialized state against the manifest's per-leaf
        CRC records (the deep SDC check — a whole-payload CRC pass with
        a per-leaf mismatch means the payload was corrupted between
        capture and commit); the raised error names the exact leaf."""
        if path is None:
            if step is None:
                raise InvalidArgumentError("pass step= or path=")
            path = self.path_for(step)
        manifest, payload = self._read(path)
        try:
            state = deserialize_bytes(payload, return_numpy=return_numpy)
        except Exception as e:
            raise CheckpointCorruptError(
                f"{path}: payload CRC ok but unpickle failed ({e})")
        if verify:
            problems = self._verify_leaves(state, manifest)
            if problems:
                raise CheckpointCorruptError(
                    f"{path}: per-leaf CRC verification failed — "
                    + "; ".join(problems))
        return state, manifest

    def load_latest(self, return_numpy: bool = False,
                    verify: bool = False) -> Optional[Tuple[Any, dict]]:
        """Newest VALID checkpoint, or None when the store is empty or
        every entry is corrupt.  Torn/corrupt/incompatible entries are
        skipped (recorded in ``last_skipped``) — the crash-recovery
        read path.  ``verify=True`` applies the deep per-leaf CRC check
        to every candidate (a leaf-level mismatch against the manifest
        records falls back to the next older checkpoint exactly like a
        torn write)."""
        self.last_skipped = []
        for step in reversed(self.steps()):
            path = self.path_for(step)
            try:
                return self.load(path=path, return_numpy=return_numpy,
                                 verify=verify)
            except (CheckpointCorruptError,
                    CheckpointIncompatibleError) as e:
                self.last_skipped.append((path, str(e)))
        return None

    def load_named(self, name: str, return_numpy: bool = False
                   ) -> Optional[Tuple[Any, dict]]:
        """The named slot's state, or None when absent or corrupt
        (corruption recorded in ``last_skipped`` — a slot has no older
        version to fall back to)."""
        path = self._slot_path(name)
        if not os.path.exists(path):
            return None
        try:
            return self.load(path=path, return_numpy=return_numpy)
        except (CheckpointCorruptError, CheckpointIncompatibleError) as e:
            self.last_skipped.append((path, str(e)))
            return None

    @staticmethod
    def _verify_leaves(state, manifest: dict) -> List[str]:
        """Per-leaf CRC comparison of a loaded state against its
        manifest records; returns problem strings naming the exact
        leaf (empty = clean)."""
        problems = []
        want = manifest.get("leaves", {})
        got = leaf_checksums(state)
        for leaf, rec in want.items():
            g = got.get(leaf)
            if g is None:
                problems.append(f"leaf {leaf!r} missing from payload")
            elif g["crc32"] != rec["crc32"]:
                problems.append(
                    f"leaf {leaf!r} CRC mismatch "
                    f"({g['crc32']} != manifest {rec['crc32']})")
        for leaf in sorted(set(got) - set(want)):
            problems.append(f"leaf {leaf!r} not in manifest")
        return problems

    def verify(self, step: Optional[int] = None,
               path: Optional[str] = None) -> List[str]:
        """Deep integrity check: payload CRC + every per-leaf CRC
        against the manifest.  Returns a list of problems (empty =
        clean); never raises for content problems.
        ``load_latest(verify=True)`` runs the same per-leaf records on
        the resume path."""
        if path is None:
            if step is None:
                raise InvalidArgumentError("pass step= or path=")
            path = self.path_for(step)
        try:
            state, manifest = self.load(path=path)
        except (CheckpointCorruptError, CheckpointIncompatibleError) as e:
            return [str(e)]
        return self._verify_leaves(state, manifest)

    def delete(self, step: int):
        try:
            os.remove(self.path_for(step))
        except OSError:
            pass

    def delete_named(self, name: str):
        try:
            os.remove(self._slot_path(name))
        except OSError:
            pass
