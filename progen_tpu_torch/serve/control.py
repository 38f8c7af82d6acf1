"""Elastic serving control plane: SLO-burn-driven fleet autoscaling,
zero-downtime weight hot-swap, and rolling worker upgrades (ported from
progen_tpu/serve/control.py).

:class:`ControlPlane` runs on the driver alongside :class:`ServeCluster`
(it is NOT another process — elasticity decisions need the router's
host-side view, which lives here already).  The drive loop calls
:meth:`tick` between poll rounds; each tick

1. **samples** the live signals: multi-window SLO burn rates from
   :class:`~progen_tpu_torch.observe.slo.BurnRateTracker` over the
   fleet-merged registry, per-prefill assigned load and per-replica
   outstanding decode tokens from the router, driver-parked request
   count, and fleet ``stage_seconds`` from worker heartbeats;
2. **asks the policy** (``serve/policy.py`` — pure, deterministic,
   cooldown/hysteresis inside) for at most one action per stage;
3. **executes** through the cluster's elastic verbs — scale-up spawns a
   fresh index through the supervised path with AOT warmup forced
   before its ready frame (warm-before-routable), scale-down fences the
   least-loaded instance and retires it with zero sheds (the worker
   drains its own queue; leftovers replay);
4. **journals** the decision as a typed event with the cause signal and
   observed values, mirrored to the tracer (``control.*`` spans in the
   merged Perfetto timeline) and the metrics registry
   (``control.scale_up``/``control.scale_down`` counters,
   ``control.prefill_workers``/``control.decode_replicas``/
   ``control.generation`` gauges), and surfaced as ``/controlz`` on the
   driver's statusz server.

:meth:`swap_weights` is the rolling upgrade: register the new weights
as a **generation** (``cluster.begin_generation``), bring up new-gen
decode replicas first (warm, routable), then roll prefill one instance
at a time — spawn the replacement on the new weights, wait routable,
fence + drain + retire the old one — so placement capacity never dips
and no request is dropped.  Requests prefilled on the old generation
keep decoding on old-generation replicas (the router routes handles by
the generation that primed them); once ``generation_in_flight(old)``
hits zero the old replicas retire.  Every completion carries the
generation tag of the weights that produced it.
"""

from __future__ import annotations

import math
import time

from progen_tpu_torch.observe import metrics as _metrics
from progen_tpu_torch.observe import trace as _trace
from progen_tpu_torch.serve.policy import BurnRatePolicy, PolicyInputs

__all__ = ["ControlPlane"]

_JOURNAL_CAP = 512


def _worst_burns(slo_results) -> dict:
    """Per-spec fastest burn across trailing windows (falling back to
    the lifetime rate when no window has data); ``inf`` strings from
    the JSON-safe form come back as ``math.inf``."""

    def _num(r):
        if r is None:
            return None
        return math.inf if r == "inf" else float(r)

    out = {}
    for res in slo_results:
        worst = None
        for w in res.get("windows", {}).values():
            r = _num(w.get("burn_rate"))
            if r is not None and (worst is None or r > worst):
                worst = r
        if worst is None:
            worst = _num(res.get("burn_rate"))
        if worst is not None:
            out[res["name"]] = worst
    return out


class ControlPlane:
    """Drives a :class:`ServeCluster`'s fleet size and weights.

    ``policy`` defaults to a :class:`BurnRatePolicy` seeded with the
    cluster's current topology as both min and starting point.  The SLO
    tracker is shared with the cluster's statusz plane when that is on
    (one tracker, one set of ``slo.*`` gauges); otherwise the control
    plane keeps its own private tracker over the same fleet-merged
    snapshot."""

    def __init__(self, cluster, policy=None, *, slo_specs=None):
        self.cluster = cluster
        self.policy = policy or BurnRatePolicy(
            min_prefill=cluster.prefill_procs,
            max_prefill=cluster.prefill_procs + 2,
            min_replicas=cluster.replicas,
            max_replicas=cluster.replicas + 2)
        self.journal: list[dict] = []
        self.ticks = 0
        self.swaps = 0
        self._last_inputs: dict = {}
        self._tracer = _trace.get_tracer()
        registry = _metrics.get_registry()
        self._up_ctr = registry.counter("control.scale_up")
        self._down_ctr = registry.counter("control.scale_down")
        self._swap_ctr = registry.counter("control.swaps")
        self._g_prefill = registry.gauge("control.prefill_workers")
        self._g_replicas = registry.gauge("control.decode_replicas")
        self._g_gen = registry.gauge("control.generation")
        if slo_specs is not None or cluster._slo is None:
            from progen_tpu_torch.observe.slo import BurnRateTracker, SLOSpec

            self._slo = BurnRateTracker(slo_specs if slo_specs is not None
                                        else (
                SLOSpec(name="latency_p95_2s", target=0.95,
                        metric="cluster.latency_s", threshold_s=2.0),
                SLOSpec(name="goodput", target=0.99, kind="ratio"),
            ), windows=(10.0, 60.0, 300.0))
        else:
            self._slo = cluster._slo
        cluster.register_statusz_provider("control", self.controlz)

    # --------------------------------------------------------------- signals

    def gather(self, now: float | None = None) -> PolicyInputs:
        """Sample the cluster into one :class:`PolicyInputs` (also what
        :meth:`tick` journals as the decision's observed context)."""
        if now is None:
            now = time.perf_counter()
        c = self.cluster
        self._slo.sample(now, c.fleet_metrics())
        burns = _worst_burns(self._slo.evaluate(now))
        stage_seconds: dict = {}
        for hb in c._hb.values():
            ss = hb.get("stage_seconds")
            for k, v in (ss.items() if ss else ()):
                stage_seconds[k] = stage_seconds.get(k, 0.0) + float(v)
        return PolicyInputs(
            now=now,
            prefill_workers=c.prefill_procs,
            decode_replicas=c.replicas,
            burn_rates=burns,
            prefill_queue=dict(c.router.prefill_load),
            replica_outstanding=dict(c.router.outstanding),
            queued_uids=len(c._parked_uids),
            stage_seconds=stage_seconds,
            queued_by_class=c.router.queued_by_class(),
            replica_cache=c.router.cache_summary(now),
            # tolerate pre-tp-group cluster stand-ins (test fakes)
            tp_group=getattr(c, "tp_group", 1),
        )

    # ----------------------------------------------------------------- ticks

    def tick(self, now: float | None = None) -> list[dict]:
        """One control round: gather → decide → execute → journal.
        Scale-up is non-blocking (the new worker warms and becomes
        routable through the normal event pump); scale-down drains the
        victim before returning.  Returns the journal entries added."""
        inputs = self.gather(now)
        self.ticks += 1
        self._last_inputs = {
            "now": round(inputs.now, 3),
            "prefill_workers": inputs.prefill_workers,
            "decode_replicas": inputs.decode_replicas,
            "burn_rates": {k: ("inf" if v == math.inf else round(v, 4))
                           for k, v in inputs.burn_rates.items()},
            "prefill_queue": dict(inputs.prefill_queue),
            "replica_outstanding": dict(inputs.replica_outstanding),
            "queued_uids": inputs.queued_uids,
            "queued_by_class": dict(inputs.queued_by_class),
            "replica_cache": {i: dict(v) for i, v in
                              inputs.replica_cache.items()},
            "tp_group": inputs.tp_group,
        }
        added = []
        for d in self.policy.decide(inputs):
            if d.action == "scale_up":
                idx = self.cluster.add_worker(d.role)
                self._up_ctr.inc()
            else:
                idx = self._pick_victim(d.role)
                if idx is None:
                    continue
                self.cluster.retire_worker(d.role, idx)
                self._down_ctr.inc()
            added.append(self._journal(
                d.action, inputs.now, role=d.role, idx=idx, cause=d.cause,
                observed=(("inf" if d.observed == math.inf
                           else round(d.observed, 4))),
                threshold=d.threshold))
        self._g_prefill.set(self.cluster.prefill_procs)
        self._g_replicas.set(self.cluster.replicas)
        self._g_gen.set(self.cluster.generation)
        return added

    def _pick_victim(self, role: str) -> int | None:
        """Scale-down victim (never one still warming up, never one
        already fenced).  Prefill: least queued.  Decode: CACHE-VALUED —
        among replicas with a fresh digest, evict the one whose cached
        pages are coldest/most-duplicated (lowest cache value, load as
        tie-break) and NEVER the sole live holder of a hot (actively
        shared) prefix; when every fresh replica is a sole holder, a
        stale-digest replica is sacrificed on load alone (its contents
        are unknown, not known-precious); when no digest is fresh the
        selection degrades to the pre-cache load-only rule.  Returns
        None when nothing is safely evictable."""
        r = self.cluster.router
        if role == "prefill":
            live = {i for i in r._placeable_prefill()
                    if (role, i) not in self.cluster._pending_routable}
            if len(live) <= 1:
                return None
            return min(sorted(live), key=lambda i: r.prefill_load.get(i, 0))
        live = {i for i in r._placeable_replicas()
                if (role, i) not in self.cluster._pending_routable}
        if len(live) <= 1:
            return None
        summary = r.cache_summary(time.perf_counter())

        def ent(i):
            return summary.get(i, {"stale": True, "value": 0.0,
                                   "sole_hot": False})

        fresh = [i for i in sorted(live) if not ent(i)["stale"]]
        if not fresh:
            # no cache knowledge at all: the pre-cache load-only rule
            return min(sorted(live), key=lambda i: r.outstanding.get(i, 0))
        cand = [i for i in fresh if not ent(i)["sole_hot"]]
        if cand:
            return min(cand, key=lambda i: (ent(i)["value"],
                                            r.outstanding.get(i, 0)))
        stale = [i for i in sorted(live) if ent(i)["stale"]]
        if stale:
            return min(stale, key=lambda i: r.outstanding.get(i, 0))
        return None  # every replica is the sole holder of a hot prefix

    # ------------------------------------------------------------------ swap

    def swap_weights(self, spec: dict | None = None, *,
                     checkpoint_path: str | None = None,
                     lora: dict | None = None,
                     timeout: float = 300.0) -> int:
        """Rolling zero-downtime weight swap; returns the new
        generation.  ``spec`` replaces the worker spec outright;
        otherwise the cluster's current spec is cloned with
        ``checkpoint_path`` and/or ``lora`` overridden.

        Sequence (capacity never dips, nothing is dropped):

        1. new-generation decode replicas spawn (warm) and become
           routable — one per live old-generation replica;
        2. prefill rolls ONE instance at a time: spawn replacement on
           the new generation, wait routable, fence + drain + retire
           the old one (its queued requests finish and ship);
        3. wait until no in-flight request primed on the old generation
           remains (they decode on the old replicas they were primed
           for), then retire the old replicas.
        """
        c = self.cluster
        old_gen = c.generation
        if spec is None:
            spec = dict(c.spec)
            if checkpoint_path is not None:
                spec["checkpoint_path"] = checkpoint_path
            if lora is not None:
                spec["lora"] = dict(lora)
        gen = c.begin_generation(spec)
        t0 = time.perf_counter()
        self._journal("swap_begin", t0, old_generation=old_gen,
                      generation=gen,
                      lora=bool(spec.get("lora")),
                      checkpoint=bool(spec.get("checkpoint_path")))

        old_replicas = sorted(
            i for i, g in c.router.replica_gen.items()
            if g == old_gen and i in c.router.replica_alive)
        old_prefill = sorted(
            i for i, g in c.router.prefill_gen.items()
            if g == old_gen and i in c.router.prefill_alive)

        # 1. new-gen decode capacity first: a new-gen prefill's handles
        # need somewhere to decode the moment it becomes routable
        for _ in old_replicas:
            idx = c.add_worker("decode", generation=gen)
            c.wait_routable("decode", idx, timeout)
            self._journal("swap_roll", time.perf_counter(), role="decode",
                          up=idx, generation=gen)

        # 2. roll prefill one at a time — replacement routable BEFORE
        # the old one fences, so placement capacity never dips
        for old_idx in old_prefill:
            idx = c.add_worker("prefill", generation=gen)
            c.wait_routable("prefill", idx, timeout)
            c.retire_worker("prefill", old_idx)
            self._journal("swap_roll", time.perf_counter(), role="prefill",
                          up=idx, down=old_idx, generation=gen)

        # 3. in-flight old-gen requests finish where they were primed
        deadline = time.perf_counter() + timeout
        while c.router.generation_in_flight(old_gen) > 0:
            if time.perf_counter() > deadline:
                raise RuntimeError(
                    f"swap: {c.router.generation_in_flight(old_gen)} "
                    f"gen-{old_gen} requests still in flight after "
                    f"{timeout}s")
            c._pump(0.05)
        for idx in old_replicas:
            c.retire_worker("decode", idx)

        self.swaps += 1
        self._swap_ctr.inc()
        self.policy.note_action("prefill", time.perf_counter())
        self.policy.note_action("decode", time.perf_counter())
        self._g_gen.set(c.generation)
        self._journal("swap_done", time.perf_counter(),
                      generation=gen, old_generation=old_gen,
                      duration_s=round(time.perf_counter() - t0, 3))
        return gen

    # --------------------------------------------------------------- journal

    def _journal(self, event: str, at: float, **fields) -> dict:
        entry = {"event": event, "at": round(at, 3), **fields,
                 "signals": dict(self._last_inputs.get("burn_rates", {}))}
        self.journal.append(entry)
        if len(self.journal) > _JOURNAL_CAP:
            del self.journal[:len(self.journal) - _JOURNAL_CAP]
        self._tracer.event(f"control.{event}", **{
            k: v for k, v in entry.items() if k not in ("event", "at")})
        return entry

    def controlz(self) -> dict:
        """The ``/controlz`` payload: policy config, decision journal,
        live fleet state, last sampled signals."""
        c = self.cluster
        return {
            "policy": self.policy.config(),
            "ticks": self.ticks,
            "swaps": self.swaps,
            "generation": c.generation,
            "fleet": {
                "prefill_procs": c.prefill_procs,
                "replicas": c.replicas,
                "tp_group": getattr(c, "tp_group", 1),
                "pending_routable": sorted(
                    f"{r}:{i}" for r, i in c._pending_routable),
                "retiring": sorted(f"{r}:{i}" for r, i in c._retiring),
                "worker_generations": {
                    f"{r}:{i}": g
                    for (r, i), g in sorted(c._worker_gen.items())},
            },
            "last_inputs": self._last_inputs,
            "journal": self.journal[-128:],
        }
