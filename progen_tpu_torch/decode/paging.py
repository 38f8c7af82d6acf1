"""Host-side page-pool bookkeeping for the paged serving engine.

The fixed-slot ServingEngine prices every request at the worst case: one
slot owns ``max_len`` rows of SGU gate cache for its whole lifetime, so
HBM per request is ``max_len`` rows even when the request uses 40.  The
paged mode (vLLM / "Ragged Paged Attention", PAPERS.md) replaces the
per-slot allocation with a GLOBAL POOL of fixed-size pages (``page_size``
token rows each) and a per-request PAGE TABLE mapping row index
``i -> pool page table[i // page_size]``:

* pages are allocated on demand as a request's position advances and
  freed (refcounted) when it completes — concurrency is bounded by
  actual live tokens, not ``slots x max_len``;
* requests sharing a prompt prefix share the read-only pages that are
  fully inside the common prefix (hash-keyed prefix cache), so a popular
  prompt's gate rows exist once in HBM no matter how many requests are
  decoding from it.

This module is the HOST side only: free lists, refcounts and the prefix
index are plain Python (they make per-request decisions between device
dispatches).  The device side — the pooled gate arrays, the page-table
walk in the decode step, and the ragged paged mix kernel — lives in
``decode/incremental.py`` and ``ops/cuda_paged_gate_mix.py``.

Two pool pages are reserved:

* page 0 (``NULL_PAGE``) is all-zeros and never written: page-table
  entries for slots a request does not own point here, so the plain
  gather version reads exact zeros for unowned rows (bit-matching the
  dense engine's zero-initialized cache tail);
* page 1 (``DUMP_PAGE``) is a write sink that is never read: masked
  scatter lanes (pad rows, prefix-shared pages, non-live slots) are
  redirected here instead of needing a predicated scatter.

Copied from progen_tpu/decode/paging.py (standard library only); the port
keeps its own copy because it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Sequence

NULL_PAGE = 0
DUMP_PAGE = 1
RESERVED_PAGES = 2


def pages_for_span(last_row: int, page_size: int) -> int:
    """Number of pages covering rows ``[0, last_row]`` inclusive."""
    if last_row < 0:
        return 0
    return last_row // page_size + 1


def token_span_digest(tokens: Sequence[int], upto: int) -> str:
    """Content hash of the first ``upto`` prime tokens.  Shared between
    ``prefix_key`` (pool-local identity) and the fleet router's digest
    matching: the router scores replicas by ``(upto, digest)`` alone, so
    it can rank placements without knowing which prefill bucket a worker
    will land the request in."""
    h = hashlib.blake2b(digest_size=16)
    for t in tokens[:upto]:
        h.update(b"%d," % int(t))
    return h.hexdigest()


def prefix_key(p_pad: int, tokens: Sequence[int], upto: int) -> tuple:
    """Hash key for the prefix page covering rows ``[upto-page_size,
    upto)``: the first ``upto`` prime tokens plus the padded prefill
    length.  ``p_pad`` is part of the key because gate rows are only
    guaranteed BIT-identical across requests when they came out of the
    same-shape prefill program (same summation trees); two requests whose
    primes land in different prefill buckets recompute rather than share.
    """
    return (p_pad, upto, token_span_digest(tokens, upto))


@dataclasses.dataclass
class SlotPages:
    """Pages owned by one in-flight request, in row order: ``pages[j]``
    covers rows ``[j*page_size, (j+1)*page_size)``.  The first ``shared``
    entries are prefix-cache hits (read-only; prefill/decode never write
    them)."""

    pages: list[int]
    shared: int


class PagePool:
    """Free list + refcounts + LRU prefix index over ``num_pages`` pages.

    ``num_pages`` counts the DEVICE pool's first axis, including the two
    reserved pages; ``capacity`` is the allocatable remainder.  Reference
    counting: every in-flight request holds one reference per page in its
    table (shared or private), and the prefix index holds one reference
    per cached page.  A page returns to the free list when its count hits
    zero; cached pages idle at refcount 1 and are reclaimed LRU-first
    when an allocation would otherwise fail.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 prefix_caching: bool = True, gate_dtype: str = "bf16"):
        if num_pages < RESERVED_PAGES + 1:
            raise ValueError(
                f"num_pages {num_pages} leaves no allocatable pages "
                f"({RESERVED_PAGES} are reserved)")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if gate_dtype not in ("bf16", "int8"):
            raise ValueError(f"gate_dtype {gate_dtype!r}: want 'bf16' "
                             "or 'int8'")
        self.num_pages = num_pages
        self.page_size = page_size
        self.prefix_caching = prefix_caching
        # bookkeeping only — the device pools live in engine state; the
        # pool records the page format so stats/capacity reports can say
        # what a page costs (int8 rows are ~2x denser than bf16)
        self.gate_dtype = gate_dtype
        # LIFO free list: recently-freed pages are reused first, which
        # keeps the working set dense and makes tests deterministic
        self._free: list[int] = list(range(num_pages - 1,
                                           RESERVED_PAGES - 1, -1))
        self._ref: dict[int, int] = {}
        self._prefix: OrderedDict[tuple, int] = OrderedDict()
        self._key_of: dict[int, tuple] = {}

    # ------------------------------------------------------------- queries

    @property
    def capacity(self) -> int:
        return self.num_pages - RESERVED_PAGES

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        return len(self._prefix)

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def _evictable(self) -> int:
        # cached pages held only by the index (refcount 1) can be dropped
        return sum(1 for pid in self._prefix.values()
                   if self._ref.get(pid, 0) == 1)

    def can_allocate(self, n: int) -> bool:
        return len(self._free) + self._evictable() >= n

    # ---------------------------------------------------------- allocation

    def allocate(self, n: int) -> list[int] | None:
        """``n`` fresh private pages (refcount 1 each), or None when the
        pool cannot supply them even after evicting idle cached pages."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if not self.can_allocate(n):
            return None
        while len(self._free) < n:
            self._evict_one_cached()
        out = [self._free.pop() for _ in range(n)]
        for pid in out:
            self._ref[pid] = 1
        return out

    def _evict_one_cached(self) -> None:
        for key, pid in self._prefix.items():  # insertion order = LRU
            if self._ref.get(pid, 0) == 1:
                del self._prefix[key]
                del self._key_of[pid]
                self._release_ref(pid)
                return
        raise RuntimeError("no evictable cached page")  # guarded by caller

    def retain(self, pid: int) -> None:
        if pid < RESERVED_PAGES:
            raise ValueError(f"cannot retain reserved page {pid}")
        if self._ref.get(pid, 0) < 1:
            raise ValueError(f"retain of unallocated page {pid}")
        self._ref[pid] += 1

    def release(self, pid: int) -> None:
        if self._ref.get(pid, 0) < 1:
            raise ValueError(f"release of unallocated page {pid}")
        self._release_ref(pid)

    def _release_ref(self, pid: int) -> None:
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            del self._ref[pid]
            self._free.append(pid)

    # -------------------------------------------------------- prefix cache

    def lookup_prefix(self, key: tuple) -> int | None:
        """Cached page for ``key`` (touches LRU), or None."""
        if not self.prefix_caching:
            return None
        pid = self._prefix.get(key)
        if pid is not None:
            self._prefix.move_to_end(key)
        return pid

    def register_prefix(self, key: tuple, pid: int) -> None:
        """Publish a just-filled full-prefix page for future sharing; the
        index takes its own reference."""
        if not self.prefix_caching or key in self._prefix or \
                pid in self._key_of:
            return
        self._prefix[key] = pid
        self._key_of[pid] = key
        self._ref[pid] = self._ref.get(pid, 0) + 1

    def unregister_prefix(self, pid: int) -> None:
        """Withdraw ``pid`` from the prefix index (no-op when it was never
        published).  Needed when the prefill that was going to FILL a
        registered page fails after planning: the index must not serve a
        page holding garbage.  The index's reference is dropped; any
        in-flight sharer keeps theirs."""
        key = self._key_of.pop(pid, None)
        if key is None:
            return
        del self._prefix[key]
        self._release_ref(pid)

    # ---------------------------------------------------------------- stats

    @property
    def shared_pages(self) -> int:
        """Page-holder edges beyond the index's own reference: a cached
        page referenced by ``k`` in-flight requests contributes ``k``.
        Zero when nothing is actively sharing."""
        return sum(self._ref.get(pid, 0) - 1
                   for pid in self._prefix.values()
                   if self._ref.get(pid, 0) > 1)

    def prefix_digest(self) -> dict:
        """Compact JSON-safe advertisement of cache contents for the
        fleet router: one ``[p_pad, upto, digest, refcount]`` row per
        cached prefix page in LRU order (coldest first), plus pool
        pressure.  Cheap enough to ride every heartbeat — the index is
        bounded by the pool size."""
        return {
            "page_size": self.page_size,
            "keys": [[k[0], k[1], k[2], self._ref.get(pid, 0)]
                     for k, pid in self._prefix.items()],
            "free": self.free_pages,
            "cached": self.cached_pages,
            "capacity": self.capacity,
        }

    def stats(self) -> dict:
        """Host-side accounting snapshot (robustness/chaos records)."""
        return {
            "num_pages": self.num_pages,
            "capacity": self.capacity,
            "free_pages": self.free_pages,
            "cached_pages": self.cached_pages,
            "shared_pages": self.shared_pages,
            "pages_in_use": self.capacity - self.free_pages,
            "gate_dtype": self.gate_dtype,
        }
