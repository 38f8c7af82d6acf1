"""Rule ``host-sync``: device→host transfers inside hot loops.

The counterpart of ``progen_tpu/analysis/rules_hostsync.py`` on torch's
sync primitives.  Each ``.item()`` / ``.tolist()`` / ``.cpu()`` /
``.numpy()`` / ``.to("cpu")``, ``float(t)`` / ``int(t)`` / ``bool(t)`` of
a tensor, ``np.asarray(t)``, ``torch.cuda.synchronize()`` and an event's
or stream's ``.synchronize()`` blocks the host until the card has run
everything queued before it — in the training loop or the serving
engine's step path that serializes the card against Python.  The rule
watches a set of *hot zones* (qualname patterns in specific files, the
JAX package's zones under their names in the port) and flags any sync
primitive applied to a value it cannot prove is already host-side.

Every function the module's capture graph reaches (``capturegraph.py``:
the bodies handed to ``CapturedProgram`` and what they call, and the
statements under ``with torch.cuda.graph(...)``) is a hot zone too.
There a sync breaks the capture on the card, while on the CPU, where the
body is called eagerly, it runs silently.

The sanctioned idiom is one explicit, batched transfer per decision
point, annotated with a suppression so every intentional sync is
grep-able:

    host = torch.stack([loss, norm]).tolist()  # graftcheck: disable=host-sync

Names assigned from a transfer (and pure-Python/numpy derivations of
them) are treated as host-safe, as names fetched by ``jax.device_get``
are in the JAX rule, so downstream ``float(host[0])`` does not flag.
A tensor's metadata (``.shape``, ``.dtype``, ``.device``, ``.size()``,
``.numel()``, ``.data_ptr()``, ...) lives on the host and never syncs.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from progen_tpu_torch.analysis.capturegraph import (
    call_name, capture_graph, own_nodes, qualnames)
from progen_tpu_torch.analysis.engine import Finding, ParsedModule, RepoContext, rule


@dataclasses.dataclass(frozen=True)
class Zone:
    path_re: str
    qual_re: str
    # self attributes known to hold host-side containers (queues, configs,
    # request bookkeeping) — reads/method calls on them are not syncs
    host_attrs: frozenset = frozenset()
    # parameter names that carry host-side payloads by contract (client
    # Request objects, JSON-safe snapshots, numpy masks) — casts and
    # asarray over them validate host data, they never drain the queue
    host_params: frozenset = frozenset()


# the hot zones for this codebase
HOT_ZONES: tuple[Zone, ...] = (
    Zone(
        r"train/trainer\.py$",
        r"Trainer\.(_run_loop|evaluate|_note_phase"
        r"|_publish_train_health|_statusz_health|_statusz_status"
        # the port's loop hands its dispatch, its log line and its
        # preemption vote to helpers (one loop serves the superstep too)
        r"|_dispatch|_emit|_preempted)$",
        frozenset({"meter", "tracker", "config", "model_config", "store",
                   "_recorder", "_tracer", "lr_schedule", "cfg",
                   "_watchdog", "_preempt_requested"}),
        # the log dict holds host floats from the loop's one batched
        # transfer — publishing them is not a new sync
        frozenset({"log"}),
    ),
    Zone(
        r"decode/engine\.py$",
        r"ServingEngine\.(step|submit|run_until_idle|_admit_pending"
        r"|_admit_pending_dense|_admit_pending_paged|_plan_slot_pages"
        r"|_free_slot_pages|_evict_slot|_ensure_chunk_pages|_harvest_done"
        r"|drain|snapshot|restore|has_work|_shed_expired|_shed|_guard"
        r"|_dispatch_chunk|_fail_inflight"
        r"|_drain_pending|robustness_counters|_prefill_round"
        r"|_admit_from_handoff|_prefill_worker_call|_merge_call"
        r"|admit_handle|run_prefill_round|drain_sheds|_note_stage"
        r"|submit_embed|_embed_round|run_embed_round|embed_pending"
        r"|_build_lmask|status|_maybe_preempt|_preempt_slot|qos_status"
        r"|_publish_qos_gauges|submit_fork|_release_forks|forget_ttft"
        r"|prefix_digest|cache_status|_publish_cache_gauges"
        # the port's admission and dispatch helpers
        r"|_dispatch|_admit_arrays|_fill_row|_fill_admit_row|_bucket"
        r"|_release_slot|_set_inactive|_merge_handle)$",
        frozenset({"_inflight", "_queue", "completions", "config",
                   "num_slots", "max_len", "chunks_run", "_pool",
                   "_slot_pages", "_page_table", "_paused", "_host_stop",
                   "_admit_order", "_admit_seq", "page_size",
                   "pages_per_row", "paged", "chunk_size", "evictions",
                   "pause_events", "prefix_hits", "robust", "_pending",
                   "_draining", "_aot", "_compiled_keys", "_defer_streak",
                   "fault_retries", "max_queue", "shed_policy",
                   "paged_impl", "_watchdog", "_handoff", "disagg",
                   "spec", "spec_k", "prefill_batch", "_max_advance",
                   "_spec_rounds", "remote_prefill", "stage_seconds",
                   "_tracer", "_stage_hist", "_embed_queue", "lora",
                   "qos_weights", "_qos_gauge_keys", "prefix_lookups",
                   "fork_groups", "_fork_wait", "_ttft"}),
        # requests, admission rows and snapshots are host payloads by API
        # contract: numpy masks, python ints, JSON-safe dicts — never
        # device arrays (the port's helpers take a request as
        # ``r: Request``)
        frozenset({"request", "rows", "snap", "r"}),
    ),
    # the page pool is pure host bookkeeping between dispatches: nothing
    # in it may touch a device value, so every sync call is a finding
    Zone(r"decode/paging\.py$", r"PagePool\..*$"),
    # the QoS scheduler runs between every admission decision: pure host
    # bookkeeping over Request metadata (priority/tenant/deadline are
    # python scalars by API contract), a sync here stalls every step.
    # __init__ is deliberately unzoned — weight validation is one-time
    Zone(r"decode/qos\.py$",
         r"(QoSQueue\.(append|appendleft|popleft|_peek|_select"
         r"|_note_served|shed_victim|remove|stats|__len__|__bool__"
         r"|__iter__|__getitem__)|_deadline_key)$",
         frozenset({"_weights", "_front", "_classes", "_deficit",
                    "_rr_at", "_rr_charged", "_seq", "_len",
                    "served_by_class", "served_by_tenant"}),
         frozenset({"r"})),
    # the handoff queue carries device arrays inside handles but is pure
    # host bookkeeping itself — any sync in it would sit on the step path
    # (module-level serialize_handle/deserialize_handle are TRANSPORT and
    # deliberately unzoned: they run on worker/transport threads where the
    # one batched device-to-host copy per frame is the whole point)
    Zone(r"decode/handoff\.py$", r"HandoffQueue\..*$",
         frozenset({"_q", "depth", "puts", "gets", "rejects"})),
    # the serving router is placement policy on the admission path: pure
    # host bookkeeping, any sync would serialize the whole cluster
    Zone(r"serve/router\.py$", r"Router\..*$",
         frozenset({"prefill_alive", "replica_alive", "prefill_load",
                    "prefill_class_load", "outstanding", "requests",
                    "stage", "batches",
                    "_uid_batch", "completed", "submit_times",
                    "max_prefill_queue", "max_outstanding",
                    "prefill_fenced", "replica_fenced",
                    "prefill_gen", "replica_gen", "uid_gen",
                    "replica_digest", "_optimistic", "_page_size_hint",
                    "route_by_cache", "digest_ttl",
                    "cache_imbalance_tokens", "cache_routed",
                    "cache_fallback", "cache_overridden"}),
         # advertised digests are parsed-JSON wire payloads and the
         # routing knobs are host scalars by constructor contract
         frozenset({"digest", "route_by_cache", "digest_ttl",
                    "cache_imbalance_tokens", "now"})),
    # the cluster's ADMISSION/event side must not sync (wire headers are
    # parsed JSON; numpy-building lives in module helpers outside the
    # zone); spawn/accept/log plumbing is transport-side and unzoned
    Zone(r"serve/cluster\.py$",
         r"ServeCluster\.(submit|_dispatch|_shed|poll|pending|drain"
         r"|_pump|_handle_event|_on_hello|_on_handle|_on_peer_dead"
         r"|_on_group_member_dead|_reap_member|_group_members"
         r"|_is_group_role"
         r"|_return_credit|_check_stale|_note_clock|fleet_metrics"
         r"|_note_cache_frame|cache_stats"
         r"|_statusz_health|_statusz_status)$",
         frozenset({"router", "completions", "supervisor", "counters",
                    "tp_group",
                    "_new", "_events", "_peers", "_procs",
                    "_handled_dead", "_respawning", "_parked_uids",
                    "_worker_stats", "_hb", "_shutting_down",
                    "stale_after", "prefill_procs", "replicas",
                    "spec", "_tracer", "_lat", "_clock_offsets",
                    "_stats_age", "_statusz", "_statusz_ports",
                    "_slo", "_slo_last", "_ok_ctr", "_shed_ctr",
                    "generation", "_worker_gen", "_worker_spec",
                    "_retiring", "_pending_routable", "_next_idx",
                    "_spec_paths", "_statusz_providers",
                    "_ttft", "_cache_counts"})),
    # the control plane's tick sits between poll rounds on the drive
    # loop: pure host policy over router/heartbeat bookkeeping, any
    # sync here would stall every request in flight
    Zone(r"serve/control\.py$",
         r"(ControlPlane\.(gather|tick|_pick_victim|_journal|controlz)"
         r"|_worst_burns)$",
         frozenset({"cluster", "policy", "journal", "ticks", "swaps",
                    "_last_inputs", "_tracer", "_slo", "_up_ctr",
                    "_down_ctr", "_swap_ctr", "_g_prefill",
                    "_g_replicas", "_g_gen"}),
         # SLO evaluate results and heartbeat stage_seconds are
         # JSON-safe host floats by contract
         frozenset({"slo_results"})),
    # (PolicyInputs and ScaleDecision, zoned in the JAX table, are
    # dataclasses with no method to zone)
    Zone(r"serve/policy\.py$",
         r"(BurnRatePolicy\.(decide|note_action|_cooling|config)"
         r"|_worst_burn)$",
         frozenset({"min_prefill", "max_prefill", "min_replicas",
                    "max_replicas", "up_burn", "down_burn",
                    "up_queue_per_worker", "down_queue_per_worker",
                    "cooldown_s", "_last_action"}),
         # PolicyInputs fields are host floats/dicts by contract
         frozenset({"inputs", "burn_rates"})),
    # span recording sits on every hot path above: it must never sync
    # (spans carry pre-computed floats, never device values)
    Zone(r"observe/trace\.py$", r"Tracer\.(span|add|event)$"),
    # the introspection plane reads host snapshots only: any sync in a
    # handler would break the zero-perturbation invariant (an enabled
    # run must be token-identical to a disabled one)
    Zone(r"observe/statusz\.py$",
         r"(StatuszServer\.(_render|_call|_json)|render_prometheus"
         r"|_fmt|_sample|_prom_name)$",
         frozenset({"role", "index", "providers", "port"}),
         # exposition inputs are JSON-safe host values by API contract
         frozenset({"v", "value", "snapshot", "base", "labels", "extra"})),
    Zone(r"observe/slo\.py$",
         r"(BurnRateTracker\.(sample|evaluate)|SLOSpec\..*|evaluate"
         r"|frac_within|frac_within_values|burn_rate|_diff_metric"
         r"|_full_counts)$",
         frozenset({"specs", "windows", "registry", "_samples"}),
         # registry snapshots and their diffs are host floats by contract
         frozenset({"snap", "snapshot", "new", "old", "values",
                    "frac_good", "target", "threshold_s", "now", "p"})),
    Zone(r"observe/metrics\.py$",
         r"(Counter\.inc|Gauge\.set|Histogram\.observe)$"),
    # micro_step is the port's name for JAX's _train_step_body
    Zone(r"train/step\.py$",
         r".*\.(train_step|micro_step|train_multi_step|eval_step)$"),
)

# a captured body: no host attributes or payloads by contract
_CAPTURED = Zone(r"", r".*")

_SYNC_CALLS = frozenset(
    {
        "np.asarray",
        "numpy.asarray",
        "np.array",
        "numpy.array",
    }
)
_WAITS = frozenset({"torch.cuda.synchronize", "cuda.synchronize"})
_CAST_CALLS = frozenset({"float", "int", "bool"})
# methods that copy a tensor to the host, or wait for the card
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
# a tensor's metadata: host values, never a sync
_META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                         "layout", "requires_grad"})
_META_METHODS = frozenset({"size", "dim", "numel", "data_ptr", "stride",
                           "element_size", "is_contiguous", "nelement",
                           "get_device"})


def _zone_for(path: str, qualname: str) -> Zone | None:
    for zone in HOT_ZONES:
        if re.search(zone.path_re, path) and re.fullmatch(
            zone.qual_re, qualname
        ):
            return zone
    return None


def _root_name(node: ast.AST) -> str | None:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        if isinstance(node, ast.Call):
            node = node.func
        else:
            node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _to_cpu(node: ast.Call) -> bool:
    """``t.to("cpu")``, ``t.to(device="cpu")``, ``t.to(torch.device("cpu"))``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    for arg in (*node.args, *(kw.value for kw in node.keywords
                              if kw.arg == "device")):
        if isinstance(arg, ast.Call) and call_name(arg) in (
                "torch.device", "device") and arg.args:
            arg = arg.args[0]
        if isinstance(arg, ast.Constant) and arg.value == "cpu":
            return True
    return False


def sync_name(node: ast.Call) -> str | None:
    """How ``node`` copies to the host or waits for the card, else None
    (casts are judged by their argument, apart from this)."""
    name = call_name(node)
    if name in _SYNC_CALLS or name in _WAITS:
        return name
    if _to_cpu(node):
        return '.to("cpu")'
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _SYNC_METHODS:
        return f".{node.func.attr}()"
    return None


class _HostSafe:
    """Names provably host-side within one function (flow-insensitive)."""

    def __init__(
        self,
        fn: ast.AST,
        host_attrs: frozenset = frozenset(),
        host_params: frozenset = frozenset(),
    ):
        self.names: set[str] = set()
        self.host_attrs = host_attrs
        args = getattr(fn, "args", None)
        # zone-declared host payload parameters seed the fixpoint
        for arg in ((*args.args, *args.posonlyargs, *args.kwonlyargs)
                    if args is not None else ()):
            if arg.arg in host_params:
                self.names.add(arg.arg)
        # fixpoint over simple assignments: transferred results and pure
        # arithmetic/numpy over host-safe names stay host-safe
        for _ in range(3):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    if self._host_value(node.value):
                        for t in node.targets:
                            self._mark(t)
                elif isinstance(node, ast.AnnAssign):
                    if node.value is not None and self._host_value(node.value):
                        self._mark(node.target)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    if self._host_value(node.iter):
                        self._mark(node.target)

    def _mark(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.names.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mark(e)

    def _host_value(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Call):
            name = call_name(node)
            # the transfer itself: its result is on the host (the sync is
            # flagged, once, where it happens)
            if sync_name(node) is not None and name not in _WAITS:
                return True
            # _host_fetch is the engine's device-to-host fetch of the slot
            # state (decode/engine.py): the sanctioned fetch per decision
            # point, as it is in the JAX engine
            if name == "_host_fetch":
                return True
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _META_METHODS:
                return True
            if name and (name.startswith("np.") or name.startswith("numpy.")
                         or name.startswith("math.")):
                return all(self._host_value(a) for a in node.args)
            if name in ("len", "range", "enumerate", "zip", "min", "max",
                        "sum", "sorted", "getattr"):
                return all(self._host_value(a) for a in node.args)
            if name in _CAST_CALLS:
                return all(self._host_value(a) for a in node.args)
            # a method call on a host-side object yields a host-side value
            # (queue.popleft(), inflight.pop(i), host_arr.copy(), ...)
            if isinstance(node.func, ast.Attribute) and self._host_value(
                node.func.value
            ):
                return True
            return False
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in _META_ATTRS:
                return True
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                return node.attr in self.host_attrs
            return self._host_value(node.value)
        if isinstance(node, ast.Subscript):
            return self._host_value(node.value)
        if isinstance(node, ast.BinOp):
            return self._host_value(node.left) and self._host_value(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._host_value(node.operand)
        if isinstance(node, ast.BoolOp):
            return all(self._host_value(v) for v in node.values)
        if isinstance(node, ast.Compare):
            return self._host_value(node.left) and all(
                self._host_value(c) for c in node.comparators
            )
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return all(self._host_value(e) for e in node.elts)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return all(self._host_value(g.iter) for g in node.generators)
        if isinstance(node, ast.IfExp):
            return self._host_value(node.body) and self._host_value(
                node.orelse
            )
        if isinstance(node, ast.JoinedStr):
            return True
        return False


def _findings(module, scope, nodes, zone, where):
    safe = _HostSafe(scope, host_attrs=zone.host_attrs,
                     host_params=zone.host_params)
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        sync = sync_name(node)
        finding = None
        if sync in _WAITS:
            finding = f"'{sync}' waits for the device"
        elif sync in _SYNC_CALLS:
            if not (node.args and safe._host_value(node.args[0])):
                finding = f"'{sync}' forces a device sync"
        elif sync is not None:
            recv = node.func.value if isinstance(node.func, ast.Attribute) \
                else None
            if recv is None or not safe._host_value(recv):
                finding = f"'{sync}' forces a device sync"
        elif name in _CAST_CALLS:
            if node.args and not safe._host_value(node.args[0]):
                arg_root = _root_name(node.args[0]) or "value"
                finding = (
                    f"'{name}({arg_root}…)' forces a device sync on a "
                    "value not fetched by one batched transfer"
                )
        if finding:
            yield Finding(
                rule="host-sync",
                path=module.path,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"{finding} inside {where}; batch into one explicit "
                    "transfer per decision point"
                ),
            )


@rule("host-sync")
def check(module: ParsedModule, ctx: RepoContext):
    quals = qualnames(module.tree)
    graph = capture_graph(module.tree)
    seen: set = set()
    for fn, qual in quals.items():
        # a captured function is held to the capture's stricter rule: no
        # zone's host contracts apply inside a graph
        zone = _CAPTURED if fn in graph.captured else _zone_for(module.path, qual)
        if zone is None:
            continue
        where = (f"captured function '{qual}'" if zone is _CAPTURED
                 else f"hot path '{qual}'")
        for f in _findings(module, fn, own_nodes(fn), zone, where):
            seen.add((f.line, f.col))
            yield f
    for region, _ in graph.regions:
        for f in _findings(module, region, graph.region_nodes(region),
                           _CAPTURED, "a 'with torch.cuda.graph' region"):
            if (f.line, f.col) not in seen:
                yield f
