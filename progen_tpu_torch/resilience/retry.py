"""What the serving engine's fault containment needs of the retry layer:
:class:`RetryError` (transient faults outlasted every in-place retry) and
:func:`default_classifier` (is an exception transient, from its TYPE and
its MESSAGE: RPC-style errors surface as plain ``RuntimeError`` with a
status word such as ``UNAVAILABLE`` in the text).

Copied from progen_tpu/resilience/retry.py, without the backoff loop
(``RetryPolicy``/``retry_call``), which nothing in the port calls yet.
"""

from __future__ import annotations


class AttemptTimeout(Exception):
    """A single attempt exceeded ``RetryPolicy.attempt_timeout``.

    The attempt's thread is abandoned (daemon), not killed; the retry
    loop proceeds as if the attempt had raised a transient error.
    """


class RetryError(Exception):
    """All attempts exhausted (or deadline hit). ``__cause__`` is the
    last underlying exception."""

    def __init__(self, msg: str, attempts: int, elapsed: float):
        super().__init__(msg)
        self.attempts = attempts
        self.elapsed = elapsed


# Status words that mark an error text as transient.  These are the
# RPC-ish statuses GCS/tensorstore/gRPC/the JAX coordination service
# produce for conditions that a later attempt can outlive; config errors
# (NOT_FOUND, PERMISSION_DENIED, INVALID_ARGUMENT) are deliberately
# absent — retrying those only delays the real failure.
_TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "RESOURCE_EXHAUSTED",  # GCS 429 rate limiting, not host OOM
    "connection reset",
    "connection refused",
    "temporarily unavailable",
    "timed out",
    "timeout",
    "broken pipe",
    "503",
    "502",
    "429",
)

# Exception class NAMES treated as transient without importing their
# packages (tf.errors.*, google.api_core, requests, tensorstore all
# surface one of these).
_TRANSIENT_TYPE_NAMES = frozenset({
    "UnavailableError",
    "DeadlineExceededError",
    "AbortedError",
    "ServiceUnavailable",
    "TooManyRequests",
    "RetryError",
    "ChunkedEncodingError",
})


def default_classifier(exc: BaseException) -> bool:
    """True when ``exc`` looks transient (worth retrying)."""
    if isinstance(exc, AttemptTimeout):
        return True
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return True
    # OSError covers flaky local/NFS/FUSE I/O, but NotADirectoryError /
    # FileNotFoundError / PermissionError subclasses are config errors
    if isinstance(exc, OSError) and not isinstance(
        exc, (FileNotFoundError, NotADirectoryError, IsADirectoryError,
              PermissionError)
    ):
        return True
    for klass in type(exc).__mro__:
        if klass.__name__ in _TRANSIENT_TYPE_NAMES:
            return True
    text = str(exc).lower()
    return any(m.lower() in text for m in _TRANSIENT_MARKERS)
