"""QoS scheduling queue: priority classes, weighted-fair tenancy, EDF.

:class:`QoSQueue` replaces the serving engine's plain FIFO admission
deque (``docs/SERVING.md`` §10).  It is deque-compatible on the surface
the engine actually uses — ``append`` / ``appendleft`` / ``popleft`` /
``remove`` / ``len`` / iteration / ``[0]`` peek — but orders requests by
a three-level policy instead of arrival alone:

1. **Priority class** (``Request.priority``, higher = more urgent):
   classes are served strictly in descending order.  A starved low
   class is relieved only by deadline sheds — strict priority is the
   point, and the engine's preemption path (``_maybe_preempt``) uses the
   same ordering to claim slots back from lower classes.
2. **Deficit-weighted round robin across tenants** inside a class:
   every tenant carries a configurable weight (default 1.0); each visit
   of the rotation grants ``weight`` credit and serving a request costs
   1.0, so long-run throughput shares converge to the weight ratios.
   Any tenant with a **nonzero weight is starvation-free** — its credit
   accumulates every rotation until it must be served.  Zero-weight
   tenants are background: they are served only when no positive-weight
   tenant in the class has queued work (work-conserving, never ahead).
3. **EDF within a tenant**: earliest deadline (``deadline``/``ttl``)
   first; deadline-less requests order FIFO after every deadlined one
   with the same key, via a monotone enqueue sequence number.

With one tenant, one class and no deadlines the whole policy degrades
to exact FIFO, so pre-QoS engine semantics (and tests) are unchanged.

``appendleft`` bypasses the policy entirely: it pushes onto a LIFO
*front stack* consulted before any class — the engine uses it for
restart-and-replay requeues and pool-starvation evictions, where
"re-admit exactly this work next" is the invariant that keeps replay
deterministic.  Policy re-enqueue (priority preemption) goes through
``append``, which preserves the request's original sequence number: a
preempted request resumes *ahead of same-class peers that arrived after
it*, but behind the higher class that displaced it.

Peek (``q[0]``) and ``popleft`` run the same deterministic selection,
so the engine's peek-then-pop admission loops admit exactly what they
inspected.  Everything here is host-side bookkeeping — no jax imports,
mirroring ``decode/paging.py``.

Copied from progen_tpu/decode/qos.py (standard library only); the port
keeps its own copy because it imports nothing of the JAX package.
"""

from __future__ import annotations

import heapq
import math
from typing import Any

__all__ = ["QoSQueue"]


def _deadline_key(r) -> float:
    """EDF sort key: absolute deadline instant, ``inf`` when unbounded
    (mirrors ``ServingEngine._deadline_of`` — ``deadline`` wins over
    ``ttl``)."""
    if getattr(r, "deadline", None) is not None:
        return r.deadline
    ttl = getattr(r, "ttl", None)
    if ttl is not None:
        return r.submit_time + ttl
    return math.inf


class QoSQueue:
    """Priority / DWRR / EDF scheduling queue (see module docstring).

    ``weights`` maps tenant id -> relative share (non-negative floats;
    missing tenants default to 1.0).  The mapping is read live, so a
    served config change applies to the next selection.
    """

    def __init__(self, weights: dict | None = None):
        self._weights: dict[int, float] = {}
        if weights:
            for t, w in weights.items():
                w = float(w)
                if w < 0:
                    raise ValueError(
                        f"qos weight for tenant {t} must be >= 0, got {w}")
                self._weights[int(t)] = w
        self._front: list = []      # LIFO replay stack; pops before policy
        # priority class -> tenant -> heap of (deadline_key, seq, request)
        self._classes: dict[int, dict[int, list]] = {}
        self._deficit: dict[int, dict[int, float]] = {}
        self._rr_at: dict[int, int] = {}       # class -> pointer tenant
        self._rr_charged: dict[int, bool] = {}  # pointer already credited
        self._seq = 0
        self._len = 0
        self.served_by_class: dict[int, int] = {}
        self.served_by_tenant: dict[int, int] = {}

    # ------------------------------------------------------------- enqueue

    def append(self, r) -> None:
        """Policy enqueue.  A request re-appended after preemption keeps
        its original sequence number (queue seniority survives the round
        trip through a slot)."""
        if getattr(r, "_qos_home", None) != id(self):
            r._qos_seq = self._seq
            r._qos_home = id(self)
            self._seq += 1
        cls = int(getattr(r, "priority", 0))
        tenant = int(getattr(r, "tenant", 0))
        heap = self._classes.setdefault(cls, {}).setdefault(tenant, [])
        heapq.heappush(heap, (_deadline_key(r), r._qos_seq, r))
        self._len += 1

    def appendleft(self, r) -> None:
        """Front-of-queue enqueue, bypassing the policy: the next pop
        returns ``r`` regardless of class or tenant.  Reserved for
        deterministic-replay requeues (engine restart, pool-starvation
        eviction) where admission order IS the correctness contract."""
        self._front.append(r)
        self._len += 1

    # --------------------------------------------------------------- serve

    def popleft(self):
        if self._front:
            self._len -= 1
            r = self._front.pop()
            self._note_served(r)
            return r
        if not self._classes:
            raise IndexError("pop from an empty QoSQueue")
        cls = max(self._classes)
        tenant = self._select(cls, commit=True)
        heap = self._classes[cls][tenant]
        _, _, r = heapq.heappop(heap)
        if not heap:
            del self._classes[cls][tenant]
            self._deficit.get(cls, {}).pop(tenant, None)
            if not self._classes[cls]:
                del self._classes[cls]
                self._deficit.pop(cls, None)
                self._rr_at.pop(cls, None)
                self._rr_charged.pop(cls, None)
        self._len -= 1
        self._note_served(r)
        return r

    def _note_served(self, r) -> None:
        cls = int(getattr(r, "priority", 0))
        tenant = int(getattr(r, "tenant", 0))
        self.served_by_class[cls] = self.served_by_class.get(cls, 0) + 1
        self.served_by_tenant[tenant] = (
            self.served_by_tenant.get(tenant, 0) + 1)

    def _peek(self):
        if self._front:
            return self._front[-1]
        if not self._classes:
            raise IndexError("peek into an empty QoSQueue")
        cls = max(self._classes)
        tenant = self._select(cls, commit=False)
        return self._classes[cls][tenant][0][2]

    def _select(self, cls: int, commit: bool) -> int:
        """DWRR tenant selection within ``cls``.  ``commit=False`` is a
        pure peek: it simulates on overlays and mutates nothing, so peek
        and the following pop agree by construction."""
        qs = self._classes[cls]
        tenants = sorted(qs)
        if len(tenants) == 1:
            t = tenants[0]
            if commit:
                self._rr_at[cls] = t
                self._rr_charged[cls] = False
            return t
        deficit = self._deficit.setdefault(cls, {})
        weights = {t: self._weights.get(t, 1.0) for t in tenants}
        positive = [w for w in weights.values() if w > 0.0]
        cur = self._rr_at.get(cls)
        charged = self._rr_charged.get(cls, False)
        if cur not in qs:
            # the pointer's tenant drained away: resume the rotation at
            # the next tenant after it (wrapping), credit not yet granted
            later = [t for t in tenants if cur is not None and t > cur]
            cur = later[0] if later else tenants[0]
            charged = False
        i = tenants.index(cur)
        order = tenants[i:] + tenants[:i]
        if not positive:
            # every queued tenant is zero-weight background: plain RR
            if commit:
                self._rr_at[cls] = order[0]
                self._rr_charged[cls] = False
            return order[0]
        over: dict[int, float] = {}  # peek overlay over ``deficit``

        def dget(t):
            return over.get(t, deficit.get(t, 0.0))

        def dset(t, v):
            if commit:
                deficit[t] = v
            else:
                over[t] = v

        # a tenant of weight w accumulates 1.0 credit within ceil(1/w)
        # rotations, so the scan is bounded (+1 absorbs float slack)
        rounds = int(math.ceil(1.0 / min(positive))) + 1
        for k in range(rounds * len(order)):
            t = order[k % len(order)]
            w = weights[t]
            if w > 0.0:
                if not charged:
                    dset(t, dget(t) + w)
                if dget(t) >= 1.0:
                    dset(t, dget(t) - 1.0)
                    if commit:
                        self._rr_at[cls] = t
                        self._rr_charged[cls] = True
                    return t
            charged = False
        # unreachable for positive weights; serve the rotation head
        if commit:
            self._rr_at[cls] = order[0]
            self._rr_charged[cls] = False
        return order[0]

    # ----------------------------------------------------------- shed hook

    def shed_victim(self):
        """The request shed-oldest should drop: lowest priority class,
        oldest enqueue within it (None when empty).  The engine compares
        its priority against the incoming request's, so a strictly
        higher-priority queued request is never shed in favor of a lower
        one."""
        best = None
        best_key = None
        for r in self._front:
            key = (int(getattr(r, "priority", 0)),
                   getattr(r, "_qos_seq", -1))
            if best_key is None or key < best_key:
                best, best_key = r, key
        for cls, by_tenant in self._classes.items():
            for heap in by_tenant.values():
                for _, seq, r in heap:
                    key = (cls, seq)
                    if best_key is None or key < best_key:
                        best, best_key = r, key
        return best

    # ------------------------------------------------------------ plumbing

    def remove(self, r) -> None:
        for i in range(len(self._front) - 1, -1, -1):
            if self._front[i] is r:
                del self._front[i]
                self._len -= 1
                return
        cls = int(getattr(r, "priority", 0))
        tenant = int(getattr(r, "tenant", 0))
        heap = self._classes.get(cls, {}).get(tenant)
        if heap is not None:
            for i, (_, _, q) in enumerate(heap):
                if q is r:
                    heap[i] = heap[-1]
                    heap.pop()
                    heapq.heapify(heap)
                    if not heap:
                        del self._classes[cls][tenant]
                        self._deficit.get(cls, {}).pop(tenant, None)
                        if not self._classes[cls]:
                            del self._classes[cls]
                            self._deficit.pop(cls, None)
                            self._rr_at.pop(cls, None)
                            self._rr_charged.pop(cls, None)
                    self._len -= 1
                    return
        raise ValueError("QoSQueue.remove(r): request not queued")

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self):
        """Scheduling-intent order: front stack (next-to-pop first),
        then classes descending, tenants ascending, EDF/FIFO within —
        a deterministic flatten, not an exact pop-order simulation (the
        DWRR rotation interleaves tenants)."""
        for r in reversed(self._front):
            yield r
        for cls in sorted(self._classes, reverse=True):
            for tenant in sorted(self._classes[cls]):
                for _, _, r in sorted(self._classes[cls][tenant],
                                      key=lambda e: (e[0], e[1])):
                    yield r

    def __getitem__(self, i) -> Any:
        if i == 0:
            return self._peek()
        items = list(self)
        return items[i]

    # ----------------------------------------------------------------- obs

    def stats(self) -> dict:
        """Host-only QoS bookkeeping for status()/robustness_counters():
        live queue depths plus cumulative scheduling (pop) tallies."""
        by_class: dict[int, int] = {}
        by_tenant: dict[int, int] = {}
        for r in self._front:
            cls = int(getattr(r, "priority", 0))
            tenant = int(getattr(r, "tenant", 0))
            by_class[cls] = by_class.get(cls, 0) + 1
            by_tenant[tenant] = by_tenant.get(tenant, 0) + 1
        for cls, by_t in self._classes.items():
            for tenant, heap in by_t.items():
                by_class[cls] = by_class.get(cls, 0) + len(heap)
                by_tenant[tenant] = by_tenant.get(tenant, 0) + len(heap)
        return {
            "queue_by_class": dict(by_class),
            "queue_by_tenant": dict(by_tenant),
            "served_by_class": dict(self.served_by_class),
            "served_by_tenant": dict(self.served_by_tenant),
            "weights": dict(self._weights),
        }
