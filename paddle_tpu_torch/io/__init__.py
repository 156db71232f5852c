"""Durable state: the crash-consistent ``CheckpointStore``."""
from .checkpoint import SCHEMA_VERSION, CheckpointStore, leaf_checksums

__all__ = ["CheckpointStore", "SCHEMA_VERSION", "leaf_checksums"]
