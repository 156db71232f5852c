"""Typed error taxonomy — the twin of ``paddle_tpu/framework/errors.py``,
copied so the port imports nothing of the JAX package.  Same class names,
bases and HTTP statuses, so callers catch the same families (an
``InvalidArgumentError`` is also a ``ValueError``) and the serving HTTP
layer derives the same status codes (``http_status_for``)."""
from __future__ import annotations

__all__ = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError",
           "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
           "PreconditionNotMetError", "PermissionDeniedError",
           "ExecutionTimeoutError", "UnimplementedError", "UnavailableError",
           "FatalError", "ExternalError", "DeadlineExceededError",
           "InternalError", "CheckpointCorruptError",
           "CheckpointIncompatibleError", "TuningTableCorruptError",
           "TuningTableIncompatibleError", "PageTransportError",
           "NumericalFaultError", "ParameterCorruptionError",
           "ERROR_HTTP_STATUS", "http_status_for", "enforce", "enforce_eq",
           "enforce_shape_match"]


class EnforceNotMet(RuntimeError):
    """Base of all framework errors (reference: platform::EnforceNotMet)."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet, ValueError):
    """A uniquely-keyed entity (request id, replica id, table name) was
    created twice.  Also a ValueError: pre-taxonomy serving code raised
    duplicate-id errors as ValueError, and callers reasonably catch it
    as one."""


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class PermissionDeniedError(EnforceNotMet, PermissionError):
    pass


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


class FatalError(EnforceNotMet):
    pass


class ExternalError(EnforceNotMet):
    pass


class DeadlineExceededError(ExecutionTimeoutError):
    """An operation's deadline/SLO passed before it could finish (the
    reference taxonomy's DEADLINE_EXCEEDED shade of timeout; serving
    maps the ``deadline_miss`` terminal status onto it)."""


class InternalError(EnforceNotMet):
    """Invariant broken inside the framework itself — the catch-all for
    crashes that are not the caller's fault (serving maps the ``failed``
    terminal status onto it)."""


class CheckpointCorruptError(EnforceNotMet):
    """A checkpoint failed integrity validation — torn write, truncated
    file, or a checksum mismatch against its manifest
    (io.checkpoint.CheckpointStore; ``load_latest`` treats this as
    "skip and fall back to the newest valid checkpoint")."""


class CheckpointIncompatibleError(PreconditionNotMetError):
    """A checkpoint is well-formed but cannot be restored here — its
    manifest schema version is newer than this build understands, or
    its captured state does not match the restoring target (a
    precondition of the restore, hence 412)."""


class TuningTableCorruptError(CheckpointCorruptError):
    """An on-disk kernel tuning table failed integrity validation —
    torn write, truncated file, bad magic, or a CRC mismatch against
    its manifest (tune.TuningTable).  The soft-loading
    runtime path (``tune.runtime``) treats this as "fall back to the
    contract-default kernel configs, never a wrong kernel"; the strict
    loaders (``TuningTable.load``, the ``verify`` CLI) raise it."""


class TuningTableIncompatibleError(CheckpointIncompatibleError):
    """A kernel tuning table is well-formed but its schema version is
    newer than this build understands (tune.TuningTable).
    Soft loading falls back to contract defaults; strict loading
    raises (a precondition of applying the table, hence 412)."""


class PageTransportError(UnavailableError):
    """A KV page failed to MOVE — a tier demotion/promotion (host-RAM /
    disk prefix tiers, serving.kv_transport) or a prefill→
    decode ship could not complete.  Always transient-infrastructure
    shaped, never a wrong answer: the tier paths degrade (a failed
    demotion discards the page exactly like the tier-off eviction, a
    failed promotion is a MISS re-prefilled from tokens, a failed ship
    leaves the request decoding where its pages already are), so this
    class surfaces only when a caller asked for a transport strictly
    (503: retry-later territory, like any unavailable replica)."""


class NumericalFaultError(InternalError):
    """Numerical damage detected by a device-side guard — a non-finite
    loss/gradient in the train step, or non-finite logits on a serving
    lane.  Server-side damage, never the caller's fault:
    serving quarantines exactly the damaged request with this class
    (HTTP 500 within one engine step) while every other stream
    continues untouched; training skips or rolls back the step
    (docs/CHECKPOINT.md "Numerical self-healing")."""


class ParameterCorruptionError(InternalError):
    """The SDC audit found a corrupted parameter leaf — a non-finite
    value in live device params, or a per-leaf CRC mismatch against a
    checkpoint manifest.  The message names the EXACT leaf;
    the anomaly runtime responds by rolling back to the newest verified
    checkpoint (docs/CHECKPOINT.md "Numerical self-healing")."""


# --- HTTP status derivation --------------------------------------------------
# One place decides how the taxonomy surfaces over HTTP, so the serving
# frontend/HTTP layer derives its status codes from the error CLASS of a
# terminal outcome instead of keeping an ad-hoc parallel table
# (serving/http.py consumes this; docs/SERVING.md "Resilience").
ERROR_HTTP_STATUS = {
    InvalidArgumentError: 400,
    OutOfRangeError: 400,
    PermissionDeniedError: 403,
    NotFoundError: 404,
    AlreadyExistsError: 409,
    PreconditionNotMetError: 412,
    ResourceExhaustedError: 429,   # overload / queue_cap — retry later
    UnimplementedError: 501,
    ExternalError: 502,            # a dependency outside the framework
    UnavailableError: 503,         # brownout / no healthy replica
    PageTransportError: 503,       # KV page move failed — transient
    DeadlineExceededError: 504,
    ExecutionTimeoutError: 504,
    CheckpointCorruptError: 500,       # durable state lost server-side
    CheckpointIncompatibleError: 412,  # restore precondition not met
    NumericalFaultError: 500,          # numeric guard tripped server-side
    ParameterCorruptionError: 500,     # SDC audit named a corrupt leaf
    InternalError: 500,
    FatalError: 500,
    # explicit base fallback: EVERY taxonomy class resolves to a status
    # through the MRO walk (tools/analyze error-taxonomy pins this)
    EnforceNotMet: 500,
}


def http_status_for(error, default: int = 500) -> int:
    """HTTP status for an error instance or class (walks the MRO, so a
    subclass inherits its nearest ancestor's mapping)."""
    cls = error if isinstance(error, type) else type(error)
    for base in cls.__mro__:
        if base in ERROR_HTTP_STATUS:
            return ERROR_HTTP_STATUS[base]
    return default


def enforce(condition, message="", error_cls=InvalidArgumentError):
    if not condition:
        raise error_cls(message)


def enforce_eq(a, b, message="", error_cls=InvalidArgumentError):
    if a != b:
        raise error_cls(f"{message} (expected {a!r} == {b!r})")


def enforce_shape_match(shape_a, shape_b, message=""):
    if tuple(shape_a) != tuple(shape_b):
        raise InvalidArgumentError(
            f"{message} (shape mismatch: {tuple(shape_a)} vs {tuple(shape_b)})"
        )
