"""Typed error taxonomy — the subset of ``paddle_tpu/framework/errors.py``
that the ported serving path raises, copied so the port imports nothing
of the JAX package.  Same class names and bases, so callers catch the
same families (an ``InvalidArgumentError`` is also a ``ValueError``)."""
from __future__ import annotations

__all__ = ["EnforceNotMet", "InvalidArgumentError", "AlreadyExistsError",
           "ResourceExhaustedError", "PreconditionNotMetError",
           "InternalError", "NumericalFaultError",
           "CheckpointIncompatibleError"]


class EnforceNotMet(RuntimeError):
    """Base of all framework errors (reference: platform::EnforceNotMet)."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class AlreadyExistsError(EnforceNotMet, ValueError):
    """A uniquely-keyed entity (request id, replica id) was created
    twice.  Also a ValueError, as in the reference package."""


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class CheckpointIncompatibleError(PreconditionNotMetError):
    """A checkpoint is well-formed but cannot be restored here — its
    schema version is newer than this build understands."""


class InternalError(EnforceNotMet):
    """Invariant broken inside the framework itself — the catch-all for
    crashes that are not the caller's fault."""


class NumericalFaultError(InternalError):
    """Numerical damage detected by a device-side guard — non-finite
    logits on a serving lane.  Serving quarantines exactly the damaged
    request with this class while every other stream continues."""
