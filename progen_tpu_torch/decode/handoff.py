"""Prefill -> decode handoff: cache handles over a bounded queue
(ported from progen_tpu/decode/handoff.py).

Disaggregated serving splits the engine's step into a PREFILL stage and a
DECODE stage.  The prefill worker runs the bucketed parallel prefill on its
own and produces a :class:`Handle`: a self-contained slab of per-row decode
state (caches, the sequence row with its first sampled token, position,
stop, key and sampling knobs) for up to ``prefill_batch`` requests, shaped
``(num_slots, ...)``, which the decode stage's merge gathers into free
slots.

The queue between the stages is BOUNDED (``handoff_depth`` handles): a full
queue skips the prefill round (backpressure: prefilled state is the
expensive thing to hold), while :meth:`HandoffQueue.requeue` puts a handle
back at the FRONT after a transiently failed merge without counting against
the bound (the handle was already admitted once; a crash-replay loop must
not deadlock against its own backpressure).

The queue is host-side bookkeeping only: handles carry device tensors, and
nothing here reads them.  :class:`Handle` and :class:`HandoffQueue` are
copied from the JAX module (standard library only); its wire format, which
carries handles between processes, is not ported yet.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any


@dataclasses.dataclass
class Handle:
    """One prefill worker product awaiting decode admission.

    ``requests``: the admitted requests in row order (row ``i`` of the
    state slabs belongs to ``requests[i]``; later rows are dummy).
    ``state``: device tensors, ``(num_slots, ...)``-shaped: seq, caches
    (dense gate rows even in paged mode; the merge scatters them into
    the pool), pos/start/stop/done/keys/top_k/temp/lmask, plus draft
    caches under speculative decoding.  ``p_pad``: the prefill bucket that
    produced it (the merge does not depend on it).
    """

    requests: list
    state: dict[str, Any]
    p_pad: int


class HandoffQueue:
    """Bounded FIFO of :class:`Handle`\\ s between the serving stages."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"handoff depth must be >= 1, got {depth}")
        self.depth = depth
        self._q: deque[Handle] = deque()
        self.puts = 0
        self.gets = 0
        self.rejects = 0

    def full(self) -> bool:
        return len(self._q) >= self.depth

    def put(self, handle: Handle) -> bool:
        """Append; False (and a ``rejects`` tick) when at depth: the
        caller should have checked :meth:`full` before paying for the
        prefill, so a reject indicates lost work."""
        if self.full():
            self.rejects += 1
            return False
        self._q.append(handle)
        self.puts += 1
        return True

    def requeue(self, handle: Handle) -> None:
        """Return a handle to the FRONT (failed merge retry path); not
        depth-bounded, see the module docstring."""
        self._q.appendleft(handle)

    def get(self) -> Handle:
        self.gets += 1
        return self._q.popleft()

    def peek(self) -> Handle:
        return self._q[0]

    def num_requests(self) -> int:
        """Requests captured in queued handles."""
        return sum(len(h.requests) for h in self._q)

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def stats(self) -> dict:
        return {"depth": self.depth, "queued": len(self._q),
                "puts": self.puts, "gets": self.gets,
                "rejects": self.rejects}
