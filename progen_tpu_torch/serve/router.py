"""Router policy: request → prefill worker, handle → decode replica.

Pure host-side bookkeeping, deliberately free of sockets and JAX so the
placement/failure logic is unit-testable (``tests/test_serve_multiproc.py``)
and syncs are structurally impossible — the module sits inside a
graftcheck host-sync zone (``analysis/rules_hostsync.py``).

Policy:

- requests go to the LEAST-LOADED live prefill worker (queued-request
  count — prefill cost is per request, not per token);
- handles go to the live replica holding the LONGEST CACHED PREFIX of
  the batch's requests (scored against the per-replica digest table the
  workers advertise on heartbeats, plus an optimistic overlay for
  handles forwarded since the last digest), ties and cache misses
  broken by LEAST OUTSTANDING TOKENS (the decode budget a replica is
  still on the hook for: sum of ``max_new_tokens`` forwarded minus
  completed) — a digest older than ``digest_ttl`` is STALE and scores
  zero, so a silent worker degrades to the load-only policy rather
  than attracting traffic on dead information;
- every request's stage is tracked (``prefill → handle → replica``), so
  a dead stage maps to exactly the uids whose work it held:
  :meth:`fail_worker` returns them for replay (seed determinism makes
  replays token-identical) or typed shedding — never an exception.

The control plane (``serve/control.py``) mutates the routable set at
runtime: :meth:`add_worker` grows a stage, :meth:`fence_worker` stops
new placements without touching in-flight bookkeeping (drain), and
:meth:`retire_worker` removes a fully drained instance.  Every worker
carries a weight **generation**; a uid is stamped with the generation
of the prefill worker that primed it and its handle may only decode on
a replica of the same generation, so per-generation determinism holds
across a rolling weight swap.

Copied from progen_tpu/serve/router.py (host bookkeeping with no
framework in it); the port keeps its own copy because it imports nothing
of the JAX package.
"""

from __future__ import annotations

from progen_tpu_torch.decode.paging import token_span_digest


class Router:
    """Placement + lifecycle bookkeeping for one serving cluster."""

    def __init__(self, prefill_workers: int, replicas: int, *,
                 route_by_cache: bool = True, digest_ttl: float = 5.0,
                 cache_imbalance_tokens: int = 32):
        if prefill_workers < 1 or replicas < 1:
            raise ValueError("need at least one prefill worker and one "
                             "replica")
        self.route_by_cache = bool(route_by_cache)
        self.digest_ttl = float(digest_ttl)
        # affinity load guard: a cache-holding replica may run at most
        # this many outstanding tokens AHEAD of the least-loaded one
        # before placement reverts to load-only — affinity must never
        # serialize the fleet onto one hot replica
        self.cache_imbalance_tokens = int(cache_imbalance_tokens)
        self.prefill_alive = set(range(prefill_workers))
        self.replica_alive = set(range(replicas))
        self.prefill_fenced: set = set()  # alive but not placeable (draining)
        self.replica_fenced: set = set()
        self.prefill_gen = {w: 0 for w in range(prefill_workers)}
        self.replica_gen = {r: 0 for r in range(replicas)}
        self.prefill_load = {w: 0 for w in range(prefill_workers)}
        # worker -> {priority class -> queued count}: the QoS view of
        # prefill_load, kept in lockstep by the same transitions
        self.prefill_class_load: dict = {
            w: {} for w in range(prefill_workers)}
        self.outstanding = {r: 0 for r in range(replicas)}
        self.requests: dict = {}          # uid -> Request
        self.stage: dict = {}             # uid -> ("prefill"|"handle"|"replica", key)
        self.batches: dict = {}           # batch_id -> {uids, src, replica, acked, open, gen}
        self._uid_batch: dict = {}        # uid -> batch_id it last rode in
        self.uid_gen: dict = {}           # uid -> generation that primed it
        self.completed: set = set()
        self.submit_times: dict = {}      # uid -> router perf_counter instant
        self.max_prefill_queue = 0
        self.max_outstanding = 0
        # replica -> {"keys": {(upto, digest): refcount}, "at": clock,
        # "page_size", "free", "cached", "capacity"} — last advertised
        # cache digest; "at" is on the ROUTER clock (the cluster stamps
        # arrival), so staleness needs no cross-process clock agreement
        self.replica_digest: dict = {}
        # replica -> {(upto, digest): forwarded-at}: prefixes we just
        # routed there and EXPECT cached before the next digest lands —
        # keeps back-to-back same-prefix placements sticky instead of
        # oscillating on heartbeat cadence
        self._optimistic: dict = {}
        self._page_size_hint = 0
        self.cache_routed = 0
        self.cache_fallback = 0
        self.cache_overridden = 0

    # ------------------------------------------------------------- placement

    def _placeable_prefill(self) -> set:
        return self.prefill_alive - self.prefill_fenced

    def _placeable_replicas(self) -> set:
        return self.replica_alive - self.replica_fenced

    def pick_prefill(self, priority: int = 0) -> int | None:
        """Least queued-requests live, unfenced prefill worker; None
        when the whole stage is down or fenced (caller sheds/parks).
        A request lands where the least work of its OWN class or above
        is queued (ties broken by total load) — lower-class backlog
        doesn't repel a high-priority request, since each worker's
        engine schedules it past that backlog anyway.  With uniform
        priorities both keys equal total load: pre-QoS placement."""
        live = self._placeable_prefill()
        if not live:
            return None

        def contending(w: int) -> int:
            return sum(n for p, n in self.prefill_class_load[w].items()
                       if p >= priority)

        return min(sorted(live),
                   key=lambda w: (contending(w), self.prefill_load[w]))

    def pick_replica(self, generation: int | None = None, *,
                     tokens_batch=None,
                     now: float | None = None) -> int | None:
        """Longest-cached-prefix live, unfenced replica (least
        outstanding tokens as tie-break and as the fallback when no
        fresh digest matches anything).  With ``generation`` set, only
        replicas serving that weight generation qualify — a handle
        primed on gen-G weights must decode on gen-G weights or
        determinism (and the swap contract) breaks.  ``tokens_batch``
        is the token sequences riding the handle; cache scoring needs
        it and ``now`` (router clock) — without them, or with
        ``route_by_cache=False``, placement is load-only.  Placement is
        a PERFORMANCE hint: a mispredicted hit costs pool pages, never
        tokens."""
        live = self._placeable_replicas()
        if generation is not None:
            live = {r for r in live
                    if self.replica_gen.get(r, 0) == generation}
        if not live:
            return None
        order = sorted(live)
        if self.route_by_cache and tokens_batch and now is not None:
            scores = {r: self._cache_score(r, tokens_batch, now)
                      for r in order}
            best = max(scores.values())
            if best > 0:
                cand = [r for r in order if scores[r] == best]
                pick = min(cand, key=lambda r: self.outstanding[r])
                least = min(order, key=lambda r: self.outstanding[r])
                if (self.outstanding[pick] - self.outstanding[least]
                        <= self.cache_imbalance_tokens):
                    self.cache_routed += 1
                    return pick
                # the cache holder is too far ahead of the least-loaded
                # replica: spill there instead — a cold prefill beats a
                # hot queue
                self.cache_overridden += 1
                return least
            self.cache_fallback += 1
        return min(order, key=lambda r: self.outstanding[r])

    def _cache_score(self, replica: int, tokens_batch, now: float) -> int:
        """Pages of the batch's primes already cached on ``replica``:
        for each request, the longest CONTIGUOUS run of full prime pages
        present in the replica's advertised (or optimistic) key set —
        the same run the engine's planner can actually share.  A stale
        digest scores 0 (fallback contract)."""
        ent = self.replica_digest.get(replica)
        keys = {}
        if ent is not None and now - ent["at"] <= self.digest_ttl:
            keys = ent["keys"]
        opt = self._optimistic.get(replica, {})
        ps = (ent or {}).get("page_size") or self._page_size_hint
        if not ps or (not keys and not opt):
            return 0
        score = 0
        for tokens in tokens_batch:
            for j in range(1, len(tokens) // ps + 1):
                k = (j * ps, token_span_digest(tokens, j * ps))
                if k in keys:
                    score += 1
                elif k in opt and now - opt[k] <= self.digest_ttl:
                    score += 1
                else:
                    break
        return score

    def note_digest(self, index: int, digest: dict, now: float) -> None:
        """Install a replica's freshly advertised cache digest.  Keys
        collapse to ``(upto, token-digest)`` — the prefill bucket
        (``p_pad``) in the pool's key is dropped, because at routing
        time the handle's bucket is already fixed and a bucket-mismatch
        "hit" merely degrades to a fresh allocation on the replica.
        Fresh truth supersedes the optimistic overlay."""
        keys: dict = {}
        for row in digest.get("keys", ()):
            _p_pad, upto, dg, ref = row
            k = (int(upto), dg)
            keys[k] = max(keys.get(k, 0), int(ref))
        ps = int(digest.get("page_size", 0))
        if ps:
            self._page_size_hint = ps
        self.replica_digest[index] = {
            "keys": keys, "at": float(now), "page_size": ps,
            "free": int(digest.get("free", 0)),
            "cached": int(digest.get("cached", 0)),
            "capacity": int(digest.get("capacity", 0)),
        }
        opt = self._optimistic.get(index)
        if opt:
            for k in list(opt):
                if k in keys or now - opt[k] > self.digest_ttl:
                    del opt[k]

    # ------------------------------------------------------------- lifecycle

    def assign_prefill(self, uid, request, worker: int, now: float) -> None:
        self.requests[uid] = request
        self.submit_times.setdefault(uid, now)
        self.stage[uid] = ("prefill", worker)
        self.uid_gen[uid] = self.prefill_gen.get(worker, 0)
        self.prefill_load[worker] += 1
        cl = self.prefill_class_load.setdefault(worker, {})
        p = getattr(request, "priority", 0)
        cl[p] = cl.get(p, 0) + 1
        self.max_prefill_queue = max(self.max_prefill_queue,
                                     self.prefill_load[worker])

    def _dec_prefill(self, worker, uid) -> None:
        """Undo one ``assign_prefill`` unit of load (stage left prefill:
        handed off, completed, or requeued)."""
        if worker in self.prefill_load:
            self.prefill_load[worker] = max(
                0, self.prefill_load[worker] - 1)
        cl = self.prefill_class_load.get(worker)
        r = self.requests.get(uid)
        if cl is not None and r is not None:
            p = getattr(r, "priority", 0)
            left = cl.get(p, 0) - 1
            if left > 0:
                cl[p] = left
            else:
                cl.pop(p, None)

    def note_handle(self, batch_id: str, uids, src: int) -> None:
        """A prefill worker shipped a handle covering ``uids``.  The
        batch entry lives until its credit is returned (:meth:`ack`)
        AND every member uid has resolved (completed or requeued) —
        then it is pruned, so long-running clusters don't grow."""
        self.batches[batch_id] = {"uids": list(uids), "src": src,
                                  "replica": None, "acked": False,
                                  "open": set(uids),
                                  "gen": self.prefill_gen.get(src, 0)}
        for uid in uids:
            self._uid_batch[uid] = batch_id
            if self.stage.get(uid, (None,))[0] == "prefill":
                self._dec_prefill(src, uid)
            self.stage[uid] = ("handle", batch_id)

    def forward(self, batch_id: str, replica: int,
                now: float | None = None) -> None:
        """The router relayed the handle frame to ``replica``.  With
        ``now`` set and cache routing on, the batch's full prime pages
        enter the replica's optimistic overlay — the replica will cache
        them on admission, and waiting a heartbeat to learn that would
        scatter a same-prefix burst across the fleet."""
        b = self.batches[batch_id]
        b["replica"] = replica
        for uid in b["uids"]:
            if uid in self.completed:
                continue
            self.stage[uid] = ("replica", replica)
            r = self.requests[uid]
            self.outstanding[replica] += int(r.max_new_tokens)
            ps = self._page_size_hint
            if now is not None and self.route_by_cache and ps:
                opt = self._optimistic.setdefault(replica, {})
                for j in range(1, len(r.tokens) // ps + 1):
                    opt.setdefault(
                        (j * ps, token_span_digest(r.tokens, j * ps)), now)
        self.max_outstanding = max(self.max_outstanding,
                                   self.outstanding[replica])

    def ack(self, batch_id: str) -> int | None:
        """Return the batch's credit: marks it acked and returns the
        producing worker so the cluster can relay the grant — None for
        an unknown OR already-acked batch.  Each batch yields exactly
        one credit ever, whether it came from replica admission or from
        a drop path (bad frame, dead replica, no replica to forward
        to), so a duplicate or late ack can never leak a grant."""
        b = self.batches.get(batch_id)
        if b is None or b["acked"]:
            return None
        b["acked"] = True
        src = b["src"]
        self._drop_batch_if_done(batch_id)
        return src

    def unacked_batches(self, replica: int) -> list:
        """Batch ids forwarded to ``replica`` whose admission ack never
        came back — when the replica dies, each still pins one credit
        of its producer's window until the cluster returns it."""
        return [bid for bid, b in self.batches.items()
                if b["replica"] == replica and not b["acked"]]

    def _drop_batch_if_done(self, batch_id) -> None:
        b = self.batches.get(batch_id)
        if b is not None and b["acked"] and not b["open"]:
            del self.batches[batch_id]

    def _leave_batch(self, uid) -> None:
        """``uid`` resolved (completed or requeued): release its seat in
        the batch it last rode in, pruning the entry once empty+acked."""
        batch_id = self._uid_batch.pop(uid, None)
        if batch_id is None:
            return
        b = self.batches.get(batch_id)
        if b is not None:
            b["open"].discard(uid)
            self._drop_batch_if_done(batch_id)

    def complete(self, uid) -> bool:
        """Record a completion; False if ``uid`` already completed (a
        replayed duplicate — identical by determinism, dropped)."""
        if uid in self.completed or uid not in self.requests:
            return False
        self.completed.add(uid)
        kind, key = self.stage.pop(uid, (None, None))
        if kind == "prefill" and key in self.prefill_load:
            self._dec_prefill(key, uid)
        elif kind == "replica" and key in self.outstanding:
            r = self.requests[uid]
            self.outstanding[key] = max(
                0, self.outstanding[key] - int(r.max_new_tokens))
        self._leave_batch(uid)
        return True

    def requeue(self, uids) -> list:
        """Clear stage bookkeeping for ``uids`` (bad frame / dead stage)
        so the cluster can re-dispatch them; returns the live subset."""
        out = []
        for uid in uids:
            if uid in self.completed or uid not in self.requests:
                continue
            kind, key = self.stage.pop(uid, (None, None))
            if kind == "prefill" and key in self.prefill_load:
                self._dec_prefill(key, uid)
            elif kind == "replica" and key in self.outstanding:
                r = self.requests[uid]
                self.outstanding[key] = max(
                    0, self.outstanding[key] - int(r.max_new_tokens))
            self._leave_batch(uid)
            out.append(uid)
        return out

    # ------------------------------------------------------------ membership

    def add_worker(self, role: str, index: int, generation: int = 0) -> None:
        """Grow a stage: ``index`` becomes alive + placeable serving
        weight ``generation``.  Idempotent for an already-known index
        (resets its load and unfences it)."""
        if role == "prefill":
            self.prefill_alive.add(index)
            self.prefill_fenced.discard(index)
            self.prefill_gen[index] = generation
            self.prefill_load[index] = 0
            self.prefill_class_load[index] = {}
        else:
            self.replica_alive.add(index)
            self.replica_fenced.discard(index)
            self.replica_gen[index] = generation
            self.outstanding[index] = 0

    def fence_worker(self, role: str, index: int) -> None:
        """Stop new placements on ``index`` without disturbing its
        in-flight bookkeeping — the drain half of retire/swap."""
        if role == "prefill":
            self.prefill_fenced.add(index)
        else:
            self.replica_fenced.add(index)

    def retire_worker(self, role: str, index: int) -> None:
        """Remove a drained instance entirely: not alive, not fenced,
        no load entry.  A retired index is never reused (the cluster
        allocates monotonically), so stale batch ids can't collide."""
        if role == "prefill":
            self.prefill_alive.discard(index)
            self.prefill_fenced.discard(index)
            self.prefill_gen.pop(index, None)
            self.prefill_load.pop(index, None)
            self.prefill_class_load.pop(index, None)
        else:
            self.replica_alive.discard(index)
            self.replica_fenced.discard(index)
            self.replica_gen.pop(index, None)
            self.outstanding.pop(index, None)
            self.replica_digest.pop(index, None)
            self._optimistic.pop(index, None)

    def generation_of(self, uid) -> int:
        """Weight generation of the prefill pass that primed ``uid``
        (0 until it has been assigned)."""
        return self.uid_gen.get(uid, 0)

    def batch_generation(self, batch_id: str) -> int:
        b = self.batches.get(batch_id)
        return 0 if b is None else b.get("gen", 0)

    def uids_on(self, role: str, index: int) -> list:
        """Uncompleted uids whose current stage is ``(role, index)``
        (for prefill: queued on the worker; for decode: decoding on the
        replica).  Handle-stage uids belong to neither until forwarded."""
        kind = "prefill" if role == "prefill" else "replica"
        return [uid for uid, (k, key) in self.stage.items()
                if k == kind and key == index and uid not in self.completed]

    def generation_in_flight(self, generation: int) -> int:
        """How many submitted-but-uncompleted uids were primed on
        ``generation`` — the swap waits for this to hit zero before
        retiring that generation's replicas."""
        return sum(1 for uid in self.stage
                   if uid not in self.completed
                   and self.uid_gen.get(uid, 0) == generation)

    # --------------------------------------------------------------- failure

    def fail_worker(self, role: str, index: int) -> list:
        """Mark a stage instance dead; returns the uids whose work it
        held (stage bookkeeping cleared, ready for re-dispatch or typed
        shedding).  Handles already relayed onward are NOT affected —
        their work left the dead process."""
        affected = []
        if role == "prefill":
            self.prefill_alive.discard(index)
            for uid, (kind, key) in self.stage.items():
                if kind == "prefill" and key == index:
                    affected.append(uid)
        else:
            self.replica_alive.discard(index)
            for uid, (kind, key) in self.stage.items():
                if kind == "replica" and key == index:
                    affected.append(uid)
            if index in self.outstanding:
                self.outstanding[index] = 0
            # a dead replica's cache died with it
            self.replica_digest.pop(index, None)
            self._optimistic.pop(index, None)
        return self.requeue(affected)

    def revive_worker(self, role: str, index: int) -> None:
        if role == "prefill":
            self.prefill_alive.add(index)
            self.prefill_load[index] = 0
            self.prefill_class_load[index] = {}
        else:
            self.replica_alive.add(index)
            self.outstanding[index] = 0

    # ------------------------------------------------------------ cache value

    def cache_summary(self, now: float) -> dict:
        """Per-replica cache VALUE for scale-down victim selection:

        - ``value``: sum over the replica's cached prefixes of
          ``refcount / holders`` — a page many in-flight requests share
          and no other replica holds is worth the most; an idle page
          duplicated fleet-wide is worth the least;
        - ``sole_hot``: the replica is the ONLY live holder of some HOT
          prefix (refcount >= 2, i.e. actively shared by in-flight
          work) — retiring it would force every future hit on that
          prefix to re-prime;
        - ``stale``: no digest fresher than ``digest_ttl`` — cache
          contents unknown, so the caller must not credit (or debit)
          this replica on cache grounds.
        """
        holders: dict = {}
        fresh: dict = {}
        for r in sorted(self.replica_alive):
            ent = self.replica_digest.get(r)
            if ent is None or now - ent["at"] > self.digest_ttl:
                continue
            fresh[r] = ent
            for k in ent["keys"]:
                holders[k] = holders.get(k, 0) + 1
        out: dict = {}
        for r in sorted(self.replica_alive):
            ent = fresh.get(r)
            if ent is None:
                out[r] = {"stale": True, "value": 0.0, "sole_hot": False}
                continue
            value = sum(ref / holders[k]
                        for k, ref in ent["keys"].items())
            sole_hot = any(ref >= 2 and holders[k] == 1
                           for k, ref in ent["keys"].items())
            out[r] = {"stale": False, "value": round(value, 6),
                      "sole_hot": sole_hot}
        return out

    # ----------------------------------------------------------------- stats

    def queued_by_class(self) -> dict:
        """Fleet-wide queued-at-prefill count per priority class — the
        control plane journals this with each decision so overload
        actions are attributable to the class that caused them."""
        agg: dict = {}
        for cl in self.prefill_class_load.values():
            for p, n in cl.items():
                agg[p] = agg.get(p, 0) + n
        return agg

    def stats(self) -> dict:
        return {
            "prefill_alive": sorted(self.prefill_alive),
            "replica_alive": sorted(self.replica_alive),
            "prefill_fenced": sorted(self.prefill_fenced),
            "replica_fenced": sorted(self.replica_fenced),
            "prefill_gen": dict(self.prefill_gen),
            "replica_gen": dict(self.replica_gen),
            "prefill_load": dict(self.prefill_load),
            "prefill_class_load": {w: dict(cl) for w, cl in
                                   self.prefill_class_load.items()},
            "queued_by_class": self.queued_by_class(),
            "outstanding_tokens": dict(self.outstanding),
            "max_prefill_queue": self.max_prefill_queue,
            "max_outstanding_tokens": self.max_outstanding,
            "open_batches": len(self.batches),
            "submitted": len(self.requests),
            "completed": len(self.completed),
            "route_by_cache": self.route_by_cache,
            "cache_routed": self.cache_routed,
            "cache_fallback": self.cache_fallback,
            "cache_overridden": self.cache_overridden,
            "replicas_with_digest": sorted(self.replica_digest),
        }
