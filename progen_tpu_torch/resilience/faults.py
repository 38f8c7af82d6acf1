"""Deterministic fault injection at named points in the training stack.

The resilience code paths (in-place retry of a serving phase, typed
sheds) run only when something fails.  This harness makes faults a test
input: production code declares **injection points** (``inject("ckpt.save")``)
that are zero-cost no-ops until a **fault plan** arms them, and the plan
is fully deterministic (counted hits + seeded RNG), so a fault test
reproduces bit-for-bit.

Plan syntax (env ``PROGEN_FAULTS``, ``train.py --inject-faults``, or
:func:`configure`): semicolon-separated entries ::

    <point>:<kind>[:opt=val[,opt=val...]]

kinds
    ``io_error``     raise a transient ``ConnectionResetError``
    ``unavailable``  raise ``RuntimeError('... UNAVAILABLE ...')`` — the
                     text shape of a dead backend/tunnel/gRPC peer
    ``fatal``        raise a non-transient ``ValueError`` (must NOT be
                     retried — tests pin the classifier with it)
    ``slow``         sleep ``delay`` seconds (default 1.0), then proceed
    ``hang``         sleep ``delay`` seconds (default 3600) — a stuck
                     step/collective for watchdog tests
    ``preempt``      send ``SIGTERM`` to this process — the real shape
                     of a TPU-VM preemption notice

options
    ``times=N``  fire on the first N hits of the point (default 1)
    ``at=K``     fire only on the K-th hit (1-based; overrides times)
    ``delay=S``  sleep length for slow/hang
    ``p=P``      fire with probability P per hit, drawn from a per-point
                 RNG seeded with ``seed ^ crc(point)`` — deterministic
                 across runs, independent across points

Example: ``ckpt.save:io_error:times=2;train.step:preempt:at=3``.

Copied from progen_tpu/resilience/faults.py (standard library only); the
port keeps its own copy because it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import threading
import time
import zlib


class InjectedFault(Exception):
    """Marker mixin so tests can assert a failure was injected."""


class InjectedIOError(InjectedFault, ConnectionResetError):
    pass


class InjectedUnavailable(InjectedFault, RuntimeError):
    pass


class InjectedFatal(InjectedFault, ValueError):
    pass


@dataclasses.dataclass
class _Rule:
    point: str
    kind: str
    times: int = 1
    at: int | None = None
    delay: float | None = None
    p: float | None = None
    fired: int = 0

    def should_fire(self, hit: int, rng: random.Random) -> bool:
        if self.p is not None:
            # the draw must happen on EVERY hit so the sequence of
            # outcomes is a pure function of (seed, point, hit index)
            if rng.random() >= self.p:
                return False
        if self.at is not None:
            return hit == self.at
        return self.fired < self.times


def parse_plan(spec: str) -> list[_Rule]:
    rules: list[_Rule] = []
    for entry in filter(None, (e.strip() for e in spec.split(";"))):
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault entry {entry!r}: want <point>:<kind>[:opt=val,...]")
        point, kind = parts[0], parts[1]
        if kind not in _KINDS:
            raise ValueError(
                f"fault entry {entry!r}: unknown kind {kind!r} "
                f"(have {sorted(_KINDS)})")
        rule = _Rule(point=point, kind=kind)
        for opt in filter(None, ",".join(parts[2:]).split(",")):
            key, _, val = opt.partition("=")
            if key == "times":
                rule.times = int(val)
            elif key == "at":
                rule.at = int(val)
            elif key == "delay":
                rule.delay = float(val)
            elif key == "p":
                rule.p = float(val)
            else:
                raise ValueError(f"fault entry {entry!r}: unknown option "
                                 f"{key!r} (times/at/delay/p)")
        rules.append(rule)
    return rules


class FaultInjector:
    """A parsed fault plan plus per-point hit counters (thread-safe:
    injection points fire from data/checkpoint worker threads too)."""

    def __init__(self, spec: str = "", seed: int = 0):
        self.spec = spec
        self.seed = seed
        self._rules = parse_plan(spec)
        self._hits: dict[str, int] = {}
        self._rngs: dict[str, random.Random] = {}
        self._lock = threading.Lock()
        self.log: list[tuple[str, str, int]] = []  # (point, kind, hit)

    def active(self) -> bool:
        return bool(self._rules)

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def fired(self, point: str | None = None) -> int:
        with self._lock:
            return len([e for e in self.log
                        if point is None or e[0] == point])

    def inject(self, point: str) -> None:
        """Count a hit of ``point``; execute any armed fault."""
        to_fire: list[tuple[_Rule, int]] = []
        with self._lock:
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            for rule in self._rules:
                if rule.point != point:
                    continue
                rng = self._rngs.get(point)
                if rng is None:
                    rng = self._rngs[point] = random.Random(
                        self.seed ^ zlib.crc32(point.encode()))
                if rule.should_fire(hit, rng):
                    rule.fired += 1
                    self.log.append((point, rule.kind, hit))
                    to_fire.append((rule, hit))
        for rule, hit in to_fire:
            _KINDS[rule.kind](rule, point, hit)


def _k_io_error(rule: _Rule, point: str, hit: int) -> None:
    raise InjectedIOError(
        f"injected transient I/O error at {point} (hit {hit})")


def _k_unavailable(rule: _Rule, point: str, hit: int) -> None:
    raise InjectedUnavailable(
        f"injected failure at {point} (hit {hit}): backend UNAVAILABLE")


def _k_fatal(rule: _Rule, point: str, hit: int) -> None:
    raise InjectedFatal(f"injected fatal error at {point} (hit {hit})")


def _k_slow(rule: _Rule, point: str, hit: int) -> None:
    time.sleep(rule.delay if rule.delay is not None else 1.0)


def _k_hang(rule: _Rule, point: str, hit: int) -> None:
    time.sleep(rule.delay if rule.delay is not None else 3600.0)


def _k_preempt(rule: _Rule, point: str, hit: int) -> None:
    os.kill(os.getpid(), signal.SIGTERM)


_KINDS = {
    "io_error": _k_io_error,
    "unavailable": _k_unavailable,
    "fatal": _k_fatal,
    "slow": _k_slow,
    "hang": _k_hang,
    "preempt": _k_preempt,
}


# ---------------------------------------------------------------------------
# process-wide injector (what production injection points consult)

_injector: FaultInjector | None = None
_env_checked = False


def configure(spec: str, seed: int = 0) -> FaultInjector:
    """Arm the process-wide plan (``spec=''`` disarms)."""
    global _injector, _env_checked
    _env_checked = True
    _injector = FaultInjector(spec, seed) if spec else None
    return _injector or FaultInjector("")


def reset() -> None:
    """Disarm and forget any env-derived plan (tests)."""
    global _injector, _env_checked
    _injector = None
    _env_checked = False


def get() -> FaultInjector | None:
    """The active injector (lazily armed from ``PROGEN_FAULTS`` once)."""
    global _injector, _env_checked
    if not _env_checked:
        _env_checked = True
        spec = os.environ.get("PROGEN_FAULTS", "")
        if spec:
            _injector = FaultInjector(
                spec, int(os.environ.get("PROGEN_FAULTS_SEED", "0")))
    return _injector


def inject(point: str) -> None:
    """Production-side injection point: free when no plan is armed."""
    inj = get()
    if inj is not None:
        inj.inject(point)
