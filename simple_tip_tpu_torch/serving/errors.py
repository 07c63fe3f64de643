"""Serving failure taxonomy: every rejection is typed, loud and explicit.

Counterpart of the JAX package's ``serving/errors.py``: callers get a typed
exception they can map onto an HTTP status, never an unbounded queue or a
hung await.
"""

from typing import Optional


class ServingError(RuntimeError):
    """Base of every scoring-service rejection."""


class RequestShed(ServingError):
    """Admission refused the request (429-style): queue or predicted-backlog
    bound exceeded, or the request was evicted under ``shed_mode=oldest``.

    ``retry_after_s`` is the predicted backlog drain time when an estimate
    exists (advisory, may be None: the estimate never decides alone).
    """

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class BackendDown(ServingError):
    """The backend is unavailable (503-style): the circuit breaker is open
    in ``mode=fail``, or a badge dispatch exhausted its retry budget."""


class EngineClosed(ServingError):
    """The engine was closed while the request was queued or submitted."""
