"""Error taxonomy.

The reference classifies errors for its retry policy into retriable (gRPC
Unavailable / DeadlineExceeded, "retryable error", "try restarting
transaction", context deadline) and permanent (client/client.go:193-211).
Device-local evaluation maps the same classes: transient device conditions
(OOM-retryable dispatch, snapshot being swapped) → Unavailable; everything
else is permanent.
"""

from __future__ import annotations


class AuthzError(Exception):
    """Base class for framework errors."""


class UnavailableError(AuthzError):
    """Transient: the evaluator/snapshot is temporarily unavailable
    (the local analogue of gRPC ``codes.Unavailable``)."""


class ShedError(UnavailableError):
    """Admission control refused the request before dispatch (bounded
    in-flight gate full, or the deadline budget cannot cover a dispatch).
    A subclass of ``UnavailableError`` ON PURPOSE: a shed engages the
    existing retry/backoff envelope — load-shedding converts queue growth
    into client-side backoff instead of unbounded buffering, the same
    move gRPC servers make by returning ``codes.Unavailable`` under
    overload."""


class DeadlineExceededError(AuthzError):
    """The context deadline passed (gRPC ``codes.DeadlineExceeded``)."""


class CancelledError(AuthzError):
    """The context was cancelled."""


class PermanentError(AuthzError):
    """Wrapper marking an error as not retriable (backoff.Permanent,
    client/client.go:202)."""


class PreconditionFailedError(AuthzError):
    """A write/delete precondition (MustMatch/MustNotMatch) failed
    (rel/txn.go:15-29 semantics)."""

    def __init__(self, message: str = "precondition failed") -> None:
        super().__init__(message)


class AlreadyExistsError(AuthzError):
    """CREATE of a relationship that already exists (the local analogue of
    gRPC ``codes.AlreadyExists``, client/client.go:450)."""


class RevisionUnavailableError(AuthzError):
    """A Snapshot()/AtLeast() revision that is unknown or has been garbage
    collected."""


class SchemaError(AuthzError):
    """Schema parse/validation failure, including writes that would leave
    relationships unreferenced (client/client.go:426-427 doc contract)."""


class PartialDeletionError(AuthzError):
    """DeleteAtomic did not complete (client/client.go:331-333)."""


class BulkCheckItemError(AuthzError):
    """One item of a bulk Check failed to evaluate.  The reference's
    CheckBulkPermissions maps per-item errors by aborting the result walk
    and returning the results accumulated so far alongside the error
    (client/client.go:279-283); ``results`` carries those partial
    per-item booleans and ``index`` the failing item's position.

    Never retriable (``is_retriable`` short-circuits on the class): the
    reference retries the RPC, not the per-item mapping — and the
    substring classifier must not re-match retry phrases inside the
    embedded cause message.  Not a PermanentError subclass because the
    retry envelope unwraps those to their cause, which would lose the
    partial results."""

    def __init__(self, index: int, results, cause: BaseException) -> None:
        super().__init__(
            f"check item {index} failed: {type(cause).__name__}: {cause}"
        )
        self.index = index
        self.results = results
        self.__cause__ = cause


class OverlapKeyMissingError(RuntimeError):
    """Raised (the reference panics) when WithOverlapRequired is set and a
    request carries no overlap key (client/client.go:182-191)."""

    def __init__(self) -> None:
        super().__init__("failed to configure required overlap key for request")


#: Substrings marking a raw device/runtime failure as transient — the
#: XLA/jax analogues of gRPC Unavailable: allocator pressure and
#: backend/transfer hiccups retry; everything else is a real bug.
TRANSIENT_DISPATCH_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "ABORTED")

#: Cross-process transport failures (fleet serving, fleet/wire.py) — the
#: OS-level analogues of gRPC Unavailable.  A replica dying shows up on
#: the router's socket as one of these (ConnectionResetError and
#: BrokenPipeError are ConnectionError subclasses; ``socket.timeout`` is
#: an alias of TimeoutError since 3.10), and the retry envelope must
#: engage — reroute/backoff — instead of surfacing a raw OSError.
TRANSPORT_ERRORS = (ConnectionError, TimeoutError, EOFError)


def classify_dispatch_exception(err: BaseException):
    """Map a raw engine/JAX dispatch failure — or a cross-process
    transport failure — onto the retry taxonomy.

    Returns an ``UnavailableError`` (with ``err`` as cause) when the
    failure is a transport error or carries a transient marker, ``err``
    itself when it is already a classified ``AuthzError``, and None when
    it is neither — the caller re-raises unclassifiable errors unchanged
    so genuine bugs keep their tracebacks."""
    if isinstance(err, AuthzError):
        return err
    if isinstance(err, TRANSPORT_ERRORS):
        e = UnavailableError(f"{type(err).__name__}: {err}")
        e.__cause__ = err
        return e
    msg = str(err)
    if any(m in msg for m in TRANSIENT_DISPATCH_MARKERS):
        e = UnavailableError(msg)
        e.__cause__ = err
        return e
    return None


def is_retriable(err: BaseException) -> bool:
    """The retry classifier (client/client.go:193-203): Unavailable /
    DeadlineExceeded classes, the two SpiceDB compat strings, or a context
    deadline error; everything else is permanent."""
    if isinstance(err, (PermanentError, BulkCheckItemError)):
        return False
    if isinstance(err, (UnavailableError, DeadlineExceededError)):
        return True
    msg = str(err)
    return "retryable error" in msg or "try restarting transaction" in msg
