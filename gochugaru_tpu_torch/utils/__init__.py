"""Cross-cutting utilities: Context, error taxonomy, retry, metrics,
fault injection, admission control."""

from .context import Context, background, todo
from .errors import (
    DeadlineExceededError,
    PermanentError,
    PreconditionFailedError,
    AlreadyExistsError,
    RevisionUnavailableError,
    ShedError,
    UnavailableError,
    classify_dispatch_exception,
)
from .retry import retry_retriable_errors

__all__ = [
    "Context",
    "background",
    "todo",
    "UnavailableError",
    "ShedError",
    "DeadlineExceededError",
    "PermanentError",
    "PreconditionFailedError",
    "AlreadyExistsError",
    "RevisionUnavailableError",
    "classify_dispatch_exception",
    "retry_retriable_errors",
]
