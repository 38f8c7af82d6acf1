"""Stall watchdog + flight recorder for the training loop.

A hung collective or device sync does not crash — it sits forever inside a
device sync while the job burns its reservation (the failure mode that
cost round 5 its dryrun artifact: rc=124 after a silent 870s hang).  The
watchdog turns "hangs forever" into "exits nonzero with a diagnosis":

* the train loop calls :meth:`Watchdog.beat` once per step;
* a monitor thread checks the heartbeat age; past ``timeout`` seconds it
  **dumps every thread's Python stack** (``sys._current_frames`` plus a
  ``faulthandler`` dump, which still works when a thread is wedged in a
  C extension) and the :class:`FlightRecorder` ring — the last N steps'
  losses, step times and checkpoint events — to the run directory, then
  exits nonzero (``os._exit``: a stuck collective blocks normal
  interpreter teardown, which is the very condition being escaped).

Both pieces are pure stdlib, so data-prep workers and tests can use them
too.  ``exit_fn`` is injectable for in-process tests.

Copied from progen_tpu/resilience/watchdog.py (standard library only): a
trip also dumps the process tracer's span ring when the process is tracing
(``observe/trace.py``).
"""

from __future__ import annotations

import collections
import faulthandler
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable

WATCHDOG_EXIT_CODE = 42  # distinct from generic failure (1) and SIGKILL


class FlightRecorder:
    """Bounded ring of recent loop events, dumpable as JSON.

    Events are dicts with a ``kind`` plus whatever the caller attaches
    (step, loss, step seconds, checkpoint paths...).  Appends are O(1)
    and lock-free enough for one writer per thread (deque is
    thread-safe for append/iteration)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)

    def record(self, kind: str, **fields: Any) -> None:
        event = {"t": time.time(), "kind": kind}
        event.update(fields)
        self._ring.append(event)

    def snapshot(self) -> list[dict]:
        return list(self._ring)

    def dump(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump({"capacity": self.capacity,
                       "events": self.snapshot()}, fh, indent=1)
        return path


def dump_all_stacks(fh) -> None:
    """Write every thread's Python stack to ``fh`` (readable form first,
    then faulthandler's, which also reaches threads wedged in C)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in frames.items():
        fh.write(f"\n--- thread {names.get(ident, '?')} ({ident}) ---\n")
        fh.write("".join(traceback.format_stack(frame)))
    fh.write("\n--- faulthandler ---\n")
    fh.flush()
    try:
        faulthandler.dump_traceback(file=fh, all_threads=True)
    except Exception:
        pass  # some file objects lack a usable fileno


class Watchdog:
    """Heartbeat monitor around a loop that must keep making progress.

    ``timeout``: max seconds between :meth:`beat` calls before tripping.
    ``out_dir``: where the stack/flight-recorder artifacts land.
    ``exit_fn``: called with :data:`WATCHDOG_EXIT_CODE` after the dump
    (default ``os._exit`` — see module docstring); tests inject a raiser.
    Use as a context manager, or ``start()``/``stop()``.
    """

    def __init__(
        self,
        timeout: float,
        out_dir: str = ".",
        recorder: FlightRecorder | None = None,
        exit_fn: Callable[[int], None] = os._exit,
        poll_interval: float | None = None,
        label: str = "train-loop",
    ):
        if timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        self.timeout = timeout
        self.out_dir = out_dir
        self.recorder = recorder
        self.label = label
        self._exit_fn = exit_fn
        self._poll = poll_interval if poll_interval is not None else min(
            1.0, timeout / 4.0)
        self._last_beat = time.monotonic()
        self._last_note: str | None = None
        self._stop = threading.Event()
        self._paused = 0
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self.tripped = False
        self.artifacts: list[str] = []

    # -- heartbeat ----------------------------------------------------------

    def beat(self, note: str | None = None) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            if note is not None:
                self._last_note = note

    def paused(self):
        """Context manager suspending the stall check for a section that
        is legitimately slow (e.g. a cold jit compile)."""
        wd = self

        class _Paused:
            def __enter__(self):
                with wd._lock:
                    wd._paused += 1
                return wd

            def __exit__(self, *exc):
                with wd._lock:
                    wd._paused -= 1
                    wd._last_beat = time.monotonic()
                return False

        return _Paused()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self.beat()
        self._thread = threading.Thread(
            target=self._monitor, name="progen-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._poll * 4 + 1.0)
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- monitor ------------------------------------------------------------

    def _monitor(self) -> None:
        while not self._stop.wait(self._poll):
            with self._lock:
                if self._paused > 0:
                    continue
                age = time.monotonic() - self._last_beat
            if age > self.timeout:
                self._trip(age)
                return

    def _trip(self, age: float) -> None:
        self.tripped = True
        stamp = time.strftime("%Y%m%d-%H%M%S")
        os.makedirs(self.out_dir, exist_ok=True)
        stacks_path = os.path.join(
            self.out_dir, f"watchdog_stacks_{stamp}.txt")
        try:
            with open(stacks_path, "w") as fh:
                fh.write(
                    f"watchdog [{self.label}]: no heartbeat for {age:.1f}s "
                    f"(timeout {self.timeout:.1f}s); last note: "
                    f"{self._last_note!r}\n")
                dump_all_stacks(fh)
            self.artifacts.append(stacks_path)
        except Exception as e:
            print(f"watchdog: stack dump failed ({e!r})", file=sys.stderr)
        if self.recorder is not None:
            ring_path = os.path.join(
                self.out_dir, f"watchdog_flight_{stamp}.json")
            try:
                self.recorder.dump(ring_path)
                self.artifacts.append(ring_path)
            except Exception as e:
                print(f"watchdog: flight-recorder dump failed ({e!r})",
                      file=sys.stderr)
        # the span ring rides along when this process is tracing: the
        # last N spans before the stall are exactly the diagnosis a hung
        # serve/train loop needs (import stays lazy: observe.trace is
        # stdlib, but the observe package itself is not)
        try:
            from progen_tpu_torch.observe.trace import get_tracer

            tracer = get_tracer()
            if tracer.enabled and tracer.ring():
                trace_path = os.path.join(
                    self.out_dir, f"watchdog_trace_{stamp}.json")
                tracer.dump(trace_path)
                self.artifacts.append(trace_path)
        except Exception as e:
            print(f"watchdog: trace-ring dump failed ({e!r})",
                  file=sys.stderr)
        print(
            f"watchdog [{self.label}]: stalled for {age:.1f}s "
            f"(> {self.timeout:.1f}s); dumped {self.artifacts} — exiting "
            f"{WATCHDOG_EXIT_CODE}",
            file=sys.stderr,
            flush=True,
        )
        self._exit_fn(WATCHDOG_EXIT_CODE)
