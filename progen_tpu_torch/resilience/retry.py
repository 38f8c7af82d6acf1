"""Generic retry with exponential backoff: the I/O fault boundary.

Every storage seam of the port routes its attempts through
:func:`retry_call` (the checkpoint store, ``checkpoint/store.py``; the
tfrecord stream's open, ``data/tfrecord.py``), so one policy decides what is
retried, how long, and with what backoff:

* **classifier, not exception whitelist**: transient-vs-fatal is decided
  by :func:`default_classifier` (overridable per policy) from the
  exception TYPE and its MESSAGE (RPC-style errors surface as plain
  ``RuntimeError`` with a status word such as ``UNAVAILABLE`` in the text);
* **seeded jitter**: backoff delays are deterministic per
  ``RetryPolicy.seed``, a schedule tests can assert on exactly;
* **total deadline** caps the whole retry loop, and **per-attempt
  timeout** bounds a single hung attempt by running it on a daemon
  thread and abandoning it;
* every attempt is observable via ``on_retry``.

Copied from progen_tpu/resilience/retry.py (standard library only); the
port keeps its own copy because it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import random
import sys
import threading
import time
from typing import Any, Callable, Iterator


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


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff/limits for one retry loop.

    ``max_attempts`` counts the first try; ``base_delay * multiplier**k``
    capped at ``max_delay`` spaces attempts, each delay scaled by a
    seeded jitter factor in ``[1-jitter, 1+jitter]``.  ``deadline`` caps
    total wall time across attempts AND sleeps; ``attempt_timeout``
    bounds one attempt (None = unbounded).
    """

    max_attempts: int = 4
    base_delay: float = 0.5
    multiplier: float = 2.0
    max_delay: float = 8.0
    jitter: float = 0.25
    deadline: float | None = 120.0
    attempt_timeout: float | None = None
    seed: int = 0
    classifier: Callable[[BaseException], bool] = default_classifier

    @classmethod
    def from_env(cls, prefix: str = "PROGEN_RETRY", **overrides) -> "RetryPolicy":
        """Policy with knobs read from ``{prefix}_ATTEMPTS`` /
        ``_BASE_DELAY`` / ``_MAX_DELAY`` / ``_DEADLINE`` /
        ``_ATTEMPT_TIMEOUT`` env vars (unset = dataclass defaults)."""
        import os

        def num(name, cast, default):
            raw = os.environ.get(f"{prefix}_{name}")
            if raw is None or raw == "":
                return default
            return cast(raw)

        fields = dict(
            max_attempts=num("ATTEMPTS", int, cls.max_attempts),
            base_delay=num("BASE_DELAY", float, cls.base_delay),
            max_delay=num("MAX_DELAY", float, cls.max_delay),
            deadline=num("DEADLINE", float, cls.deadline),
            attempt_timeout=num("ATTEMPT_TIMEOUT", float,
                                cls.attempt_timeout),
        )
        fields.update(overrides)
        return cls(**fields)

    def delays(self) -> Iterator[float]:
        """The deterministic jittered backoff schedule (one delay per
        retry, i.e. ``max_attempts - 1`` values)."""
        rng = random.Random(self.seed)
        for k in range(max(0, self.max_attempts - 1)):
            raw = min(self.max_delay, self.base_delay * self.multiplier ** k)
            yield raw * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


def _run_with_timeout(fn: Callable[[], Any], timeout: float) -> Any:
    """Run ``fn`` on a daemon thread, abandoning it past ``timeout``."""
    out: queue.Queue = queue.Queue(maxsize=1)

    def target() -> None:
        try:
            out.put((True, fn()))
        except BaseException as e:  # delivered to the caller below
            out.put((False, e))

    t = threading.Thread(target=target, name="progen-retry-attempt",
                         daemon=True)
    t.start()
    try:
        ok, value = out.get(timeout=timeout)
    except queue.Empty:
        raise AttemptTimeout(
            f"attempt exceeded {timeout:.1f}s (worker thread abandoned)"
        ) from None
    if ok:
        return value
    raise value


def retry_call(
    fn: Callable[..., Any],
    *args: Any,
    policy: RetryPolicy | None = None,
    label: str | None = None,
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    **kwargs: Any,
) -> Any:
    """Call ``fn(*args, **kwargs)`` under ``policy``.

    Retries only exceptions the policy's classifier deems transient;
    fatal exceptions propagate immediately.  Exhaustion raises
    :class:`RetryError` chained to the last failure.  ``on_retry(attempt,
    exc, delay)`` fires before each backoff sleep (default: print once
    per loop from a single process-wide seam, see ``_announce``).
    """
    policy = policy or RetryPolicy()
    name = label or getattr(fn, "__name__", "call")
    start = time.monotonic()
    delays = policy.delays()
    last: BaseException | None = None
    for attempt in range(1, max(1, policy.max_attempts) + 1):
        try:
            if policy.attempt_timeout is not None:
                return _run_with_timeout(
                    lambda: fn(*args, **kwargs), policy.attempt_timeout)
            return fn(*args, **kwargs)
        except BaseException as e:
            last = e
            if not policy.classifier(e):
                raise
            elapsed = time.monotonic() - start
            delay = next(delays, None)
            if delay is None or (
                policy.deadline is not None
                and elapsed + delay > policy.deadline
            ):
                break
            (on_retry or _announce)(attempt, e, delay)
            time.sleep(delay)
    elapsed = time.monotonic() - start
    raise RetryError(
        f"{name}: gave up after {attempt} attempt(s) in {elapsed:.1f}s: "
        f"{last!r}",
        attempts=attempt,
        elapsed=elapsed,
    ) from last


def _announce(attempt: int, exc: BaseException, delay: float) -> None:
    # the line and its newline in one write: a retry on the Trainer's save
    # thread never splits a JSON line the main thread writes
    sys.stdout.write(f"transient failure (attempt {attempt}): {exc!r}; "
                     f"retrying in {delay:.2f}s\n")
    sys.stdout.flush()


def retriable(policy: RetryPolicy | None = None, label: str | None = None):
    """Decorator form of :func:`retry_call`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, *args, policy=policy,
                              label=label or fn.__name__, **kwargs)

        return wrapper

    return deco
