"""The port's static analyzer (``progen_tpu_torch/analysis``) against the
JAX package's (``progen_tpu/analysis``).

* Parity: every framework-neutral case of ``tests/test_graftcheck.py``
  (suppressions, baseline, JSON/human/SARIF output, the CFG and its
  dataflow, ``resource-leak``, ``wire-*``, ``det-*``, stale suppressions)
  goes through both analyzers, which must give the same
  ``(rule, line, message)`` lists, the same CFGs and the same bytes of
  output.  The mechanics cases of that file use ``dtype-pet`` on
  ``jnp.einsum``, which is JAX-specific (the port's ``dtype-pet`` is about
  torch's precision switches), so here they use ``resource-leak`` on a
  discarded ``pool.allocate`` in its place: the same line, the same
  suppression comments.  The raw ``resource-leak`` and
  ``wire-const-mismatch`` findings of every file of both packages agree.
* One true positive and one true negative for each torch counterpart
  rule.
* The capture graph's roots on the port, the zone and pair tables'
  entries against the port's files, defects injected into copies of the
  port's files, the CLI, and the zero-findings gate over the port.
"""

import ast
import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from progen_tpu import analysis as jax_analysis
from progen_tpu.analysis import cfg as jax_cfg
from progen_tpu.analysis import engine as jax_engine
from progen_tpu_torch import analysis
from progen_tpu_torch.analysis import capturegraph
from progen_tpu_torch.analysis import cfg as port_cfg
from progen_tpu_torch.analysis import engine
from progen_tpu_torch.analysis import rules_determinism, rules_hostsync, rules_wire

pytestmark = pytest.mark.analysis

ROOT = Path(__file__).resolve().parent.parent

jax_analysis.load_rules()
analysis.load_rules()


def port_path(path: str) -> str:
    """A JAX case's path under the port: the zones name the port's files."""
    return re.sub(r"^progen_tpu/", "progen_tpu_torch/", path)


def triples(findings):
    return [(f.rule, f.line, f.message) for f in findings]


def both(source, path="progen_tpu/some/module.py", rules=None, report_stale=False):
    src = textwrap.dedent(source)
    want = jax_engine.check_source(src, path=path, rules=rules, report_stale=report_stale)
    got = engine.check_source(src, path=port_path(path), rules=rules,
                              report_stale=report_stale)
    return want, got


# ---------------------------------------------------------------------------
# parity: check_source cases
# ---------------------------------------------------------------------------

# the suppression cases' subject: a discarded acquire on line 3
_BARE = """
def attend(pool, n):
    pool.allocate(n){comment}
"""

PARITY_CASES = {
    # suppressions (test_graftcheck.py: test_suppression_*)
    "suppression_on_finding_line": (
        _BARE.format(comment="  # graftcheck: disable=resource-leak"),
        "progen_tpu/ops/x.py", ["resource-leak"], False),
    "suppression_on_preceding_comment_line": ("""
        def attend(pool, n):
            # graftcheck: disable=resource-leak
            pool.allocate(n)
        """, "progen_tpu/ops/x.py", ["resource-leak"], False),
    "suppression_file_wide": ("""
        # graftcheck: disable-file=resource-leak
        def attend(pool, n):
            pool.allocate(n)
        """, "progen_tpu/ops/x.py", ["resource-leak"], False),
    "suppression_of_other_rule_does_not_hide": (
        _BARE.format(comment="  # graftcheck: disable=host-sync"),
        "progen_tpu/ops/x.py", ["resource-leak"], False),
    "trailing_comment_on_previous_code_line_does_not_leak": ("""
        def attend(pool, n):
            n = n * 2  # graftcheck: disable=resource-leak
            pool.allocate(n)
        """, "progen_tpu/ops/x.py", ["resource-leak"], False),
    # resource-leak (test_resource_leak_*)
    "leak_exception_path": ("""
        def admit(pool, n, bad):
            pages = pool.allocate(n)
            if bad:
                raise ValueError("no capacity")
            pool.release(pages)
        """, "progen_tpu/some/module.py", ["resource-leak"], False),
    "leak_early_return": ("""
        def admit(pool, n, ok):
            pages = pool.allocate(n)
            if not ok:
                return None
            pool.release(pages)
            return n
        """, "progen_tpu/some/module.py", ["resource-leak"], False),
    "leak_ownership_transfer": ("""
        def grab(pool, n):
            pages = pool.allocate(n)
            return pages
        """, "progen_tpu/some/module.py", ["resource-leak"], False),
    "leak_release_in_finally": ("""
        def hold(pool, n):
            pages = pool.allocate(n)
            try:
                pages.append(0)
            finally:
                pool.release(pages)
        """, "progen_tpu/some/module.py", ["resource-leak"], False),
    "leak_failed_allocate_none_branch": ("""
        def admit(pool, n):
            pages = pool.allocate(n)
            if pages is None:
                return None
            pool.release(pages)
            return n
        """, "progen_tpu/some/module.py", ["resource-leak"], False),
    "leak_discarded_acquire": ("""
        def f(pool, n):
            pool.allocate(n)
        """, "progen_tpu/some/module.py", ["resource-leak"], False),
    "leak_unexited_span": ("""
        def f(tracer, work):
            s = tracer.span("step")
            work()
            return 1
        """, "progen_tpu/some/module.py", ["resource-leak"], False),
    "leak_span_context_manager": ("""
        def f(tracer, x):
            with tracer.span("step"):
                return x + 1
        """, "progen_tpu/some/module.py", ["resource-leak"], False),
    "leak_suppression_on_acquire_line": ("""
        def f(pool, n):
            pages = pool.allocate(n)  # graftcheck: disable=resource-leak
            return 1
        """, "progen_tpu/some/module.py", ["resource-leak"], False),
    "leak_ack_credit_fixture": (
        (ROOT / "tests" / "fixtures" / "ack_credit_leak.py").read_text(),
        "tests/fixtures/ack_credit_leak.py", ["resource-leak"], False),
    # wire (test_wire_*)
    "wire_dead_field_and_strict_read": ("""
        def thing_to_wire(r):
            msg = {"uid": r.uid, "n": int(r.n), "ghost": 1}
            if r.pri != 0:
                msg["pri"] = r.pri
            return msg

        def thing_from_wire(d):
            return (d["uid"], d["n"], d["pri"])
        """, "progen_tpu/some/module.py", ["wire-dead-field", "wire-strict-read"], False),
    "wire_pair_with_fallbacks_is_clean": ("""
        def thing_to_wire(r):
            msg = {"uid": r.uid}
            if r.pri != 0:
                msg["pri"] = r.pri
            return msg

        def thing_from_wire(d):
            return (d["uid"], d.get("pri", 0))
        """, "progen_tpu/some/module.py", ["wire-dead-field", "wire-strict-read"], False),
    "wire_const_mismatch": ("""
        import struct

        FRAME_VERSION = 1

        def pack_frame(b):
            return struct.pack("<4sI", b, FRAME_VERSION)

        def unpack_frame(buf):
            return struct.unpack("<4sH", buf)

        FRAME_VERSION = 2
        """, "progen_tpu/some/module.py", ["wire-const-mismatch"], False),
    "wire_const_consistent_is_clean": ("""
        import struct

        FRAME_VERSION = 1

        def pack_frame(b):
            return struct.pack("<4sI", b, FRAME_VERSION)

        def unpack_frame(buf):
            return struct.unpack("<4sI", buf)
        """, "progen_tpu/some/module.py", ["wire-const-mismatch"], False),
    # determinism zones (test_det_*)
    "det_set_iter_flags_qos_decision": ("""
        def pick(queues):
            ready = {q for q in queues if q}
            for q in ready:
                return q
            return None
        """, "progen_tpu/decode/qos.py", ["det-set-iter"], False),
    "det_set_iter_accepts_sorted": ("""
        def pick(queues):
            ready = {q for q in queues if q}
            for q in sorted(ready):
                return q
            return None
        """, "progen_tpu/decode/qos.py", ["det-set-iter"], False),
    "det_set_iter_out_of_zone": ("""
        def pick(queues):
            ready = {q for q in queues if q}
            for q in ready:
                return q
            return None
        """, "progen_tpu/core/ops.py", ["det-set-iter"], False),
    "det_wallclock_zone": ("""
        import time

        def order(q):
            return time.time()
        """, "progen_tpu/decode/qos.py", ["det-wallclock"], False),
    "det_wallclock_sanctioned_clock": ("""
        import time

        def _maybe_preempt(self):
            return time.perf_counter()
        """, "progen_tpu/decode/engine.py", ["det-wallclock"], False),
    "det_ambient_rng": ("""
        import random

        def draft(xs):
            return xs[int(random.random() * len(xs))]
        """, "progen_tpu/decode/spec.py", ["det-ambient-rng"], False),
    "det_seeded_rng_is_clean": ("""
        import random

        def draft(xs, seed):
            rng = random.Random(seed)
            return xs[rng.randrange(len(xs))]
        """, "progen_tpu/decode/spec.py", ["det-ambient-rng"], False),
    "det_hash_order_dependence": ("""
        def key(x):
            return hash(x)
        """, "progen_tpu/decode/qos.py", ["det-ambient-rng"], False),
    # stale suppressions (test_stale_suppression_*, docstring case)
    "stale_suppression_reported_live_one_kept": ("""
        def f(pool, n):
            pool.allocate(n)  # graftcheck: disable=resource-leak

        def g(x):
            return x  # graftcheck: disable=resource-leak
        """, "progen_tpu/ops/x.py", None, True),
    "stale_suppression_off": ("""
        def f(pool, n):
            pool.allocate(n)  # graftcheck: disable=resource-leak

        def g(x):
            return x  # graftcheck: disable=resource-leak
        """, "progen_tpu/ops/x.py", None, False),
    "suppression_example_in_docstring_is_inert": ('''
        """Module docs showing the grammar:

            x = risky()  # graftcheck: disable=resource-leak
        """

        def g(x):
            return x
        ''', "progen_tpu/ops/x.py", None, True),
}

# the cases whose JAX counterpart finds something: parity must not be two
# empty lists everywhere
EXPECT_FINDINGS = {
    "suppression_of_other_rule_does_not_hide",
    "trailing_comment_on_previous_code_line_does_not_leak",
    "leak_exception_path", "leak_early_return", "leak_discarded_acquire", "leak_unexited_span",
    "leak_ack_credit_fixture", "wire_dead_field_and_strict_read", "wire_const_mismatch",
    "det_set_iter_flags_qos_decision", "det_wallclock_zone", "det_ambient_rng",
    "det_hash_order_dependence", "stale_suppression_reported_live_one_kept",
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_check_source_parity(case):
    source, path, rules, stale = PARITY_CASES[case]
    want, got = both(source, path=path, rules=rules, report_stale=stale)
    assert triples(got) == triples(want)
    assert bool(want) == (case in EXPECT_FINDINGS), triples(want)


def _port_and_jax_files():
    return sorted((ROOT / "progen_tpu").rglob("*.py")) + sorted(
        (ROOT / "progen_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("rule", ["resource-leak", "wire-const-mismatch"])
def test_neutral_rules_agree_on_both_packages(rule):
    """The raw findings (suppressions not applied) of the copied rules over
    every file of both packages, read as text, are the JAX rules'."""
    ctx_jax = jax_engine.RepoContext(root=ROOT)
    ctx_port = engine.RepoContext(root=ROOT)
    want, got = [], []
    for path in _port_and_jax_files():
        rel = path.relative_to(ROOT).as_posix()
        src = path.read_text()
        tree = ast.parse(src)
        want += [(rel, *t) for t in triples(jax_engine.RULES[rule](
            jax_engine.ParsedModule(rel, src, tree, src.splitlines()), ctx_jax))]
        got += [(rel, *t) for t in triples(engine.RULES[rule](
            engine.ParsedModule(rel, src, tree, src.splitlines()), ctx_port))]
    assert got == want
    if rule == "resource-leak":  # the suppressed handoff pops, in both engines
        assert {p for p, *_ in want} >= {"progen_tpu/decode/engine.py",
                                         "progen_tpu_torch/decode/engine.py"}


# ---------------------------------------------------------------------------
# parity: baseline and the output formats
# ---------------------------------------------------------------------------


def _findings_pair():
    """The same finding from both analyzers, on the same path."""
    src, path = textwrap.dedent(_BARE.format(comment="")), "progen_tpu_torch/ops/x.py"
    return (jax_engine.check_source(src, path=path, rules=["resource-leak"]),
            engine.check_source(src, path=path, rules=["resource-leak"]))


def test_baseline_roundtrip_parity(tmp_path):
    want, got = _findings_pair()
    assert len(want) == 1
    jax_eng_file, port_file = tmp_path / "jax.json", tmp_path / "port.json"
    jax_engine.save_baseline(jax_eng_file, want)
    engine.save_baseline(port_file, got)
    assert port_file.read_bytes() == jax_eng_file.read_bytes()
    baseline = engine.load_baseline(port_file)
    assert baseline == jax_engine.load_baseline(jax_eng_file)
    new, old = engine.apply_baseline(got, baseline)
    assert new == [] and len(old) == 1
    # keys ignore line numbers: a shifted finding stays baselined
    shifted = engine.check_source("\n\n\n" + _BARE.format(comment=""),
                                  path="progen_tpu_torch/ops/x.py", rules=["resource-leak"])
    new, old = engine.apply_baseline(shifted, baseline)
    assert new == [] and len(old) == 1
    # ...but another path is a new finding
    other = engine.check_source(_BARE.format(comment=""),
                                path="progen_tpu_torch/decode/y.py", rules=["resource-leak"])
    new, old = engine.apply_baseline(other, baseline)
    assert len(new) == 1 and old == []


@pytest.mark.parametrize("fmt", ["format_json", "format_human", "format_sarif"])
@pytest.mark.parametrize("baselined", [0, 2])
def test_output_formats_are_byte_identical(fmt, baselined):
    want, port_findings = _findings_pair()
    assert getattr(engine, fmt)(port_findings, baselined=baselined) == \
        getattr(jax_engine, fmt)(want, baselined=baselined)
    empty = getattr(engine, fmt)([], baselined=baselined)
    assert empty == getattr(jax_engine, fmt)([], baselined=baselined)
    if fmt == "format_json":
        payload = json.loads(getattr(engine, fmt)(port_findings, baselined=baselined))
        assert payload["count"] == 1 and payload["baselined"] == baselined
        assert set(payload["findings"][0]) == {"rule", "path", "line", "col", "message"}
    if fmt == "format_sarif":
        doc = json.loads(getattr(engine, fmt)(port_findings, baselined=baselined))
        (res,) = doc["runs"][0]["results"]
        assert res["locations"][0]["physicalLocation"]["region"]["startColumn"] >= 1


# ---------------------------------------------------------------------------
# parity: the CFG and its dataflow
# ---------------------------------------------------------------------------

CFG_CASES = {
    "if_else": """
        def f(a):
            x = 1
            if a:
                y = 2
            else:
                y = 3
            return y
        """,
    "while_loop": """
        def f(n):
            while n:
                n = step(n)
            return n
        """,
    "early_return": """
        def f(a):
            if a:
                return 1
            tail(a)
            return 2
        """,
    "finally": """
        def f(a):
            try:
                work(a)
            finally:
                cleanup(a)
            return a
        """,
    "exception_edge": """
        def f(a):
            try:
                risky(a)
            except ValueError:
                a = 0
            return a
        """,
    "loop_fixpoint": """
        def f(a):
            x = 1
            while a:
                x = x + 1
            return x
        """,
    "nested": """
        def f(xs, pool):
            for x in xs:
                if x is None:
                    continue
                try:
                    with pool.lock():
                        if x > 3:
                            break
                        pool.put(x)
                except (KeyError, ValueError):
                    raise
                else:
                    pool.note(x)
                finally:
                    pool.flush()
            else:
                return None
            return xs
        """,
}


def _cfg_dump(mod, source):
    g = mod.build_cfg(ast.parse(textwrap.dedent(source)).body[0])
    nodes = [(n.idx, n.kind, n.line) for n in g.nodes]
    edges = sorted((i, d, lab) for i in range(len(g.nodes)) for d, lab in g.successors(i))
    states = mod.forward_dataflow(g, init=frozenset(),
                                  transfer=lambda node, state, label: state | {node.kind},
                                  join=lambda a, b: a | b)
    return nodes, edges, {k: sorted(v) for k, v in states.items()}


@pytest.mark.parametrize("case", sorted(CFG_CASES))
def test_cfg_and_dataflow_parity(case):
    want = _cfg_dump(jax_cfg, CFG_CASES[case])
    assert _cfg_dump(port_cfg, CFG_CASES[case]) == want
    assert want[1]  # a graph with edges


def test_copied_modules_keep_the_originals_code():
    """``cfg.py`` is the original verbatim but for its provenance line."""
    orig = (ROOT / "progen_tpu/analysis/cfg.py").read_text()
    copy = (ROOT / "progen_tpu_torch/analysis/cfg.py").read_text()
    assert [ast.dump(n) for n in ast.parse(copy).body[1:]] == \
        [ast.dump(n) for n in ast.parse(orig).body[1:]]
    for name in ("dotted", "call_name", "unwrap_partial", "target_simple_name",
                 "walk_functions", "qualnames"):
        fns = [{n.name: ast.dump(n) for n in ast.parse(p.read_text()).body
                if isinstance(n, ast.FunctionDef)}
               for p in (ROOT / "progen_tpu/analysis/jaxgraph.py",
                         ROOT / "progen_tpu_torch/analysis/capturegraph.py")]
        assert fns[0][name] == fns[1][name], name


# ---------------------------------------------------------------------------
# the torch counterpart rules: a true positive and a true negative each
# ---------------------------------------------------------------------------


def check(source, path="progen_tpu_torch/some/module.py", rules=None):
    return engine.check_source(textwrap.dedent(source), path=path, rules=rules)


def rule_names(findings):
    return [f.rule for f in findings]


_CAPTURED_BODY = """
import time
import random
import numpy as np
from progen_tpu_torch.decode.graphs import CapturedProgram


class Engine:
    def __init__(self, paged):
        self._chunk = self._chunk_paged if paged else self._chunk_dense

    def _chunk_dense(self, state):
        {stmt}
        return state

    def _chunk_paged(self, state, table):
        return state

    def warm(self, state):
        def capture(key, body, *args):
            self.programs[key] = CapturedProgram(body, *args, device="cuda")

        capture("chunk", self._chunk, state)

    def step(self, state):
        {stmt}
        return state
"""


@pytest.mark.parametrize("stmt,rule,hits", [
    ("print(state)", "trace-safety", 1),
    ("t = time.perf_counter()", "trace-safety", 1),
    ("u = np.random.rand()", "trace-safety", 1),
    ("n = state['pos'].max().item()", "host-sync", 1),
    ("n = int(state['pos'].sum())", "host-sync", 1),
    ("p = state['pos'].cpu()", "host-sync", 1),
    ("p = state['pos'].to('cpu')", "host-sync", 1),
    ("n = int(state['pos'].shape[0])", "host-sync", 0),
    ("n = state['pos'].size(0) + state['pos'].numel()", "host-sync", 0),
    ("n = state['pos'] + 1", "trace-safety", 0),
])
def test_capture_rules_follow_the_forwarded_body(stmt, rule, hits):
    """The body reaches ``CapturedProgram`` through ``capture``'s ``body``
    parameter and ``self._chunk``'s binding: its statement is captured,
    the same statement in the uncaptured ``step`` is not."""
    findings = check(_CAPTURED_BODY.format(stmt=stmt), rules=[rule])
    assert len(findings) == hits, engine.format_human(findings)
    if hits:
        assert "'Engine._chunk_dense'" in findings[0].message \
            or "'_chunk_dense'" in findings[0].message


def test_capture_rules_see_a_factorys_body_and_a_graph_region():
    src = """
        import torch
        from progen_tpu_torch.decode.graphs import CapturedProgram

        def make(model):
            def helper(x):
                return x.item()

            def step(state):
                def body(x):
                    return helper(x)
                return body

            def run(state, x):
                return CapturedProgram(step(state), x, device="cuda")

            return run

        def replay(fn, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = fn(x)
                print(y)
            return g
        """
    findings = check(src, rules=["host-sync", "trace-safety"])
    assert [(f.rule, f.line) for f in findings] == [("host-sync", 7), ("trace-safety", 23)]
    graph = capturegraph.CaptureGraph(ast.parse(textwrap.dedent(src)))
    assert set(graph.roots) == {"make.step.body"}
    assert {graph.quals[d] for d in graph.captured} == {"make.step.body", "make.helper"}


def test_host_sync_in_a_zone_and_the_batched_transfer():
    bad = """
        class Trainer:
            def _run_loop(self, metrics):
                return {"loss": float(metrics["loss"]), "lr": float(metrics["lr"])}
        """
    findings = check(bad, path="progen_tpu_torch/train/trainer.py", rules=["host-sync"])
    assert rule_names(findings) == ["host-sync", "host-sync"]
    good = """
        import torch

        class Trainer:
            def _run_loop(self, metrics):
                host = torch.stack(  # graftcheck: disable=host-sync
                    [metrics["loss"], metrics["lr"]]).tolist()
                return {"loss": float(host[0]), "lr": float(host[1])}
        """
    assert check(good, path="progen_tpu_torch/train/trainer.py", rules=["host-sync"]) == []
    sync = """
        import torch

        class Trainer:
            def _run_loop(self, ev):
                torch.cuda.synchronize()
                ev.synchronize()
        """
    findings = check(sync, path="progen_tpu_torch/train/trainer.py", rules=["host-sync"])
    assert rule_names(findings) == ["host-sync", "host-sync"]


@pytest.mark.parametrize("src,hits", [
    ("""
        from progen_tpu_torch.decode import rng

        def sample(key, n):
            a = rng.uniform(key, n)
            b = rng.gumbel(key, n)
            return a + b
        """, ["rng-reuse"]),
    ("""
        from progen_tpu_torch.decode import rng

        def sample(key, n):
            key, sub = rng.split_key(key)
            a = rng.uniform(sub, n)
            key, sub = rng.split_key(key)
            return a + rng.gumbel(sub, n)
        """, []),
    ("""
        from progen_tpu_torch.decode import rng

        def chain(keys):
            out = []
            for _ in range(3):
                out.append(rng.random_bits(keys, 4))
            return out
        """, ["rng-reuse"]),
    ("""
        from progen_tpu_torch.decode import rng

        def advance(keys):
            rng.split(keys)
            return keys
        """, ["rng-split-dropped"]),
    ("""
        from progen_tpu_torch.decode import rng

        def advance(key_data):
            _, _unused = rng.split_key(key_data)
            return key_data
        """, ["rng-split-dropped"]),
    ("""
        from progen_tpu_torch.decode import rng

        def advance(key_data):
            nxt, sub = rng.split_key(key_data)
            return nxt, sub
        """, []),
])
def test_rng_rules_on_the_key_chain(src, hits):
    findings = check(src, rules=["rng-reuse", "rng-split-dropped"])
    assert rule_names(findings) == hits, engine.format_human(findings)


@pytest.mark.parametrize("src,path,hits", [
    ("import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n",
     "progen_tpu_torch/ops/x.py", ["dtype-pet"]),
    ("import torch\ntorch.backends.cudnn.allow_tf32 = True\n",
     "progen_tpu_torch/models/x.py", ["dtype-pet"]),
    ("import torch\ntorch.set_float32_matmul_precision('high')\n",
     "progen_tpu_torch/train/x.py", ["dtype-pet"]),
    ("import torch\n"
     "torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True\n",
     "progen_tpu_torch/decode/x.py", ["dtype-pet"]),
    ("import torch\ntorch.set_float32_matmul_precision('highest')\n"
     "torch.backends.cuda.matmul.allow_tf32 = False\n",
     "progen_tpu_torch/ops/x.py", []),
    ("import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n",
     "progen_tpu_torch/observe/x.py", []),  # outside the numeric core
    ("def f(x):\n    return x.to(torch.bfloat16) * 1e-6\n",
     "progen_tpu_torch/ops/x.py", ["dtype-f32-literal"]),
    ("def f(x):\n    return x.bfloat16() + 0.1\n",
     "progen_tpu_torch/ops/x.py", ["dtype-f32-literal"]),
    ("def f(x):\n    return torch.ones(3, dtype=torch.bfloat16) * 0.3\n",
     "progen_tpu_torch/ops/x.py", ["dtype-f32-literal"]),
    ("def f(x):\n    return x.to(torch.bfloat16) * 0.5\n",
     "progen_tpu_torch/ops/x.py", []),
    ("def f(x):\n    return x.float() * 1e-6\n",
     "progen_tpu_torch/ops/x.py", []),
])
def test_dtype_rules_on_torch(src, path, hits):
    findings = check(src, path=path, rules=["dtype-pet", "dtype-f32-literal"])
    assert rule_names(findings) == hits, engine.format_human(findings)


@pytest.mark.parametrize("expr,bad", [
    ('mesh["seq"]', False),
    ('mesh["data", "fsdp"]', False),
    ('self.mesh["sequence"]', True),
    ('mesh.get_group("tensor")', False),
    ('mesh.get_group("model")', True),
    ('mesh.get_local_rank("sq")', True),
    ('MESH_AXES.index("tensor")', False),
    ('mesh.mesh_dim_names.index("pipe")', True),
    ('mesh_sizes(mesh)["fsdp"]', False),
    ('mesh_sizes(mesh)["fdsp"]', True),
    ('init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "tensor"))', False),
    ('init_device_mesh("cuda", (2, 2), mesh_dim_names=("dp", "tensor"))', True),
    ('mesh.get_group(axis)', False),
])
def test_mesh_axis_on_device_mesh_lookups(expr, bad):
    ctx = engine.build_context(ROOT)
    assert ctx.mesh_axes == frozenset({"data", "fsdp", "tensor", "seq"})
    findings = engine.check_source(f"def f(self, mesh, axis):\n    return {expr}\n",
                                   path="progen_tpu_torch/x.py", rules=["mesh-axis"], ctx=ctx)
    assert rule_names(findings) == (["mesh-axis"] if bad else [])


@pytest.mark.parametrize("call,bad", [
    ("torch.rand(3)", True),
    ("torch.randn_like(x)", True),
    ("torch.randint(0, 5, (3,))", True),
    ("torch.multinomial(x, 1)", True),
    ("torch.bernoulli(x)", True),
    ("x.normal_()", True),
    ("torch.manual_seed(0)", True),
    ("torch.rand(3, generator=gen)", False),
    ("torch.multinomial(x, 1, generator=gen)", False),
    ("x.uniform_(generator=gen)", False),
    ("torch.zeros(3)", False),
])
def test_det_ambient_rng_flags_torchs_global_generator(call, bad):
    src = f"import torch\n\ndef draft(x, gen):\n    return {call}\n"
    findings = engine.check_source(src, path="progen_tpu_torch/decode/spec.py",
                                   rules=["det-ambient-rng"])
    assert rule_names(findings) == (["det-ambient-rng"] if bad else [])
    assert engine.check_source(src, path="progen_tpu_torch/models/x.py",
                               rules=["det-ambient-rng"]) == []  # out of zone


_LAUNCH = """
import torch
from progen_tpu_torch.ops import plain


def run(fn, x, out):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    {body}
    return out
"""


@pytest.mark.parametrize("body,hits", [
    ("fn(x.data_ptr(), out.data_ptr(), stream)", ["kernel-status"]),
    ("_ = fn(x.data_ptr(), out.data_ptr(), stream)", ["kernel-status"]),
    ("err = fn(x.data_ptr(), out.data_ptr(), stream)", ["kernel-status"]),
    ("err = fn(x.data_ptr(), out.data_ptr(), stream)\n"
     "    if err != 0:\n        raise RuntimeError(err)", []),
    ("check(fn(x.data_ptr(), out.data_ptr(), stream))", []),
    ("if fn(x.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream):\n"
     "        raise RuntimeError('launch failed')", []),
    ("args = (x.data_ptr(), out.data_ptr(), stream)\n    fn(*args)", ["kernel-status"]),
    ("try:\n        err = fn(x.data_ptr(), out.data_ptr(), stream)\n"
     "        if err:\n            raise RuntimeError(err)\n"
     "    except RuntimeError:\n        return plain.gated_mix(x)", ["kernel-fallback"]),
    ("try:\n        err = fn(x.data_ptr(), out.data_ptr(), stream)\n"
     "        if err:\n            raise RuntimeError(err)\n"
     "    except RuntimeError:\n        pass", ["kernel-fallback"]),
    ("try:\n        err = fn(x.data_ptr(), out.data_ptr(), stream)\n"
     "        if err:\n            raise RuntimeError(err)\n"
     "    except RuntimeError as e:\n        raise ValueError('K2') from e", []),
])
def test_kernel_rules(body, hits):
    findings = check(_LAUNCH.format(body=body), path="progen_tpu_torch/ops/cuda_x.py",
                     rules=["kernel-status", "kernel-fallback"])
    assert rule_names(findings) == hits, engine.format_human(findings)


def test_kernel_fallback_sees_a_wrapper_call():
    src = """
        from progen_tpu_torch.ops import cuda_sgu, sgu

        def gate(res, gate, w, b):
            try:
                return cuda_sgu.spatial_gate_fwd(res, gate, w, b)
            except RuntimeError:
                return sgu.plain_gated_mix(res, gate, w, b)
        """
    assert rule_names(check(src, rules=["kernel-fallback"])) == ["kernel-fallback"]


def test_kernel_status_covers_every_kernel_of_the_port():
    """Each kernel's launch is seen, and checked, in its wrapper: K1-fwd,
    K1-dq, K1-dkv (the halo entry rides the same launches), K2-fwd and
    K2-dgate (through ``_run``), K2-dW, K3 and K3-q8 (one launch site, the
    simt and bulk routes)."""
    from progen_tpu_torch.analysis import rules_kernel

    seen = {}
    for name in ("cuda_attention", "cuda_sgu", "cuda_paged_gate_mix"):
        tree = ast.parse((ROOT / "progen_tpu_torch/ops" / f"{name}.py").read_text())
        for fn in capturegraph.walk_functions(tree):
            if rules_kernel._launches(fn):
                seen.setdefault(name, set()).add(fn.name)
    assert seen == {
        "cuda_attention": {"local_attention_fwd", "local_attention_bwd_dq",
                           "local_attention_bwd_dkv"},
        "cuda_sgu": {"_run", "spatial_gate_dw"},
        "cuda_paged_gate_mix": {"launch"},
    }


# ---------------------------------------------------------------------------
# the capture graph on the port
# ---------------------------------------------------------------------------


def test_capture_graph_roots_on_the_port():
    roots = {}
    for path in sorted((ROOT / "progen_tpu_torch").rglob("*.py")):
        graph = capturegraph.CaptureGraph(ast.parse(path.read_text()))
        for name, defs in graph.roots.items():
            roots[(path.relative_to(ROOT).as_posix(), name)] = sorted(
                graph.quals[d] for d in defs)
    engine_py, step_py = "progen_tpu_torch/decode/engine.py", "progen_tpu_torch/train/step.py"
    assert roots == {
        (engine_py, "ServingEngine._embed_impl"): ["ServingEngine._embed_impl"],
        (engine_py, "ServingEngine._prefill_worker"): ["ServingEngine._prefill_worker_impl"],
        (engine_py, "ServingEngine._admit"): ["ServingEngine._admit_impl",
                                              "ServingEngine._admit_paged_impl"],
        (engine_py, "ServingEngine._merge"): ["ServingEngine._merge_impl"],
        (engine_py, "ServingEngine._decode_chunk"): [
            "ServingEngine._decode_chunk_impl", "ServingEngine._decode_chunk_paged_impl",
            "ServingEngine._decode_chunk_spec_impl",
            "ServingEngine._decode_chunk_spec_paged_impl"],
        (step_py, "make_train_functions.optimizer_step.body"): [
            "make_train_functions.optimizer_step.body"],
    }


def test_capture_graph_reaches_what_the_bodies_call():
    tree = ast.parse((ROOT / "progen_tpu_torch/decode/engine.py").read_text())
    graph = capturegraph.CaptureGraph(tree)
    captured = {graph.quals[d] for d in graph.captured}
    # the chunk's helpers, the spec chunk's nested draft step, and the
    # module-level merge the merge body calls (not ServingEngine._merge,
    # which is no method)
    assert {"ServingEngine._advance", "ServingEngine._spec_chunk",
            "ServingEngine._spec_chunk.draft_step", "_merge"} <= captured
    # the host side of the engine is not captured
    assert not captured & {"ServingEngine.step", "ServingEngine._dispatch_chunk",
                           "ServingEngine.aot_warmup", "ServingEngine._admit_pending_dense"}


# ---------------------------------------------------------------------------
# the tables name the port's files and functions
# ---------------------------------------------------------------------------


def _alternatives(pattern: str) -> list[str]:
    """Expand the alternations of a zone regex into plain alternatives
    (groups, ``(?:...)``, ``|`` and an optional group ``(...)?``)."""

    def parse(i):
        seqs, cur = [], [""]
        while i < len(pattern):
            c = pattern[i]
            if c == "\\":
                cur = [s + pattern[i:i + 2] for s in cur]
                i += 2
            elif c == "(":
                start = i
                i += 3 if pattern.startswith("(?:", i) else 1
                inner, i = parse(i)
                if pattern[i:i + 1] == "?":  # optional: kept as it stands
                    inner, i = [pattern[start:i + 1]], i + 1
                cur = [s + alt for s in cur for alt in inner]
            elif c == ")":
                return seqs + cur, i + 1
            elif c == "|":
                seqs, cur = seqs + cur, [""]
                i += 1
            else:
                cur = [s + c for s in cur]
                i += 1
        return seqs + cur, i

    return parse(0)[0]


def _quals(path: Path) -> set[str]:
    return set(capturegraph.qualnames(ast.parse(path.read_text())).values())


def _zone_misses(path_re: str, qual_re: str) -> list[str]:
    files = [p for p in sorted((ROOT / "progen_tpu_torch").rglob("*.py"))
             if re.search(path_re, p.relative_to(ROOT).as_posix())]
    if not files:
        return [f"no file matches {path_re}"]
    quals = set().union(*map(_quals, files))
    return [alt for alt in _alternatives(qual_re)
            if not any(re.fullmatch(alt, q) for q in quals)]


@pytest.mark.parametrize("zone", rules_hostsync.HOT_ZONES, ids=lambda z: z.path_re)
def test_hot_zones_name_the_ports_functions(zone):
    assert _zone_misses(zone.path_re, zone.qual_re) == []


@pytest.mark.parametrize("zone", rules_determinism.DET_ZONES, ids=lambda z: z.path_re)
def test_det_zones_name_the_ports_functions(zone):
    assert _zone_misses(zone.path_re, zone.qual_re) == []


def test_a_stale_zone_is_caught():
    assert _zone_misses(r"train/trainer\.py$",
                        r"Trainer\.(_run_loop|_run_loop_superstep)$") == [
        r"Trainer\._run_loop_superstep$"]
    assert _zone_misses(r"progen_tpu/decode/qos\.py$", r".*") == [
        r"no file matches progen_tpu/decode/qos\.py$"]


@pytest.mark.parametrize("pair", rules_wire.WIRE_PAIRS, ids=lambda p: p.name)
def test_wire_pairs_name_the_ports_functions(pair):
    for relpath, func, scrape in pair.writers:
        fn = rules_wire._find_fn(ast.parse((ROOT / relpath).read_text()), func)
        assert fn is not None, (relpath, func)
        assert rules_wire.scrape_writer(fn, scrape), (relpath, func, scrape)
    for relpath, func, var in pair.readers:
        fn = rules_wire._find_fn(ast.parse((ROOT / relpath).read_text()), func)
        assert fn is not None, (relpath, func)
        assert rules_wire.scrape_reader(fn, {var}), (relpath, func, var)


# ---------------------------------------------------------------------------
# injected defects: the CLI must exit 1
# ---------------------------------------------------------------------------


def _cli(*args, cwd=ROOT):
    return subprocess.run([sys.executable, "-m", "progen_tpu_torch.analysis", *args],
                          capture_output=True, text=True, cwd=cwd, timeout=120)


def _jax_cli(*args):
    return subprocess.run([sys.executable, str(ROOT / "tools" / "graftcheck.py"), *args],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)


def _inject(tmp_path, rel, old, new):
    text = (ROOT / rel).read_text()
    assert text.count(old) == 1, old
    dst = tmp_path / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(text.replace(old, new))
    return dst


_LEAK = """\
def admit(pool, n, ok):
    pages = pool.allocate(n)
    if pages is None:
        return None
    if not ok:
        return None          # injected: early return, pages never freed
    for p in pages:
        pool.release(p)
    return n
"""

INJECTIONS = {
    "page_leak_on_early_return": ("resource-leak", None, None, None),
    "item_in_captured_body": (
        "host-sync", "progen_tpu_torch/decode/engine.py",
        "    def _decode_chunk_impl(self, state: dict) -> dict:\n"
        "        st = self._working_copy(state)\n",
        "    def _decode_chunk_impl(self, state: dict) -> dict:\n"
        "        st = self._working_copy(state)\n        st[\"pos\"].max().item()\n"),
    "dropped_kernel_err": (
        "kernel-status", "progen_tpu_torch/ops/cuda_sgu.py",
        "    err = fn(*ptrs, batch, n, d,", "    fn(*ptrs, batch, n, d,"),
    "try_except_calls_the_plain_twin": (
        "kernel-fallback", "progen_tpu_torch/ops/cuda_sgu.py",
        "    _run(fn, name, (res.data_ptr(), gate.data_ptr(), weights.data_ptr(),\n"
        "                    biases.data_ptr(), out.data_ptr()), gate)\n",
        "    try:\n"
        "        _run(fn, name, (res.data_ptr(), gate.data_ptr(), weights.data_ptr(),\n"
        "                        biases.data_ptr(), out.data_ptr()), gate)\n"
        "    except RuntimeError:\n"
        "        return plain.gated_mix(res, gate, weights, biases)\n"),
}


@pytest.mark.parametrize("case", sorted(INJECTIONS))
def test_injected_defect_fails_the_cli(tmp_path, case):
    rule, rel, old, new = INJECTIONS[case]
    if rel is None:
        target = tmp_path / "leak.py"
        target.write_text(_LEAK)
    else:
        target = _inject(tmp_path, rel, old, new)
        # the copy unchanged is clean: the defect is what fails
        clean = tmp_path / "clean" / rel
        clean.parent.mkdir(parents=True)
        clean.write_text((ROOT / rel).read_text())
        proc = _cli("--no-baseline", "--allow-stale", str(clean))
        assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = _cli("--no-baseline", str(target))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert f"[{rule}]" in proc.stdout


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

# JAX's rules with no subject in the port (ROADMAP.md, "Not to port")
NOT_PORTED = {"donation", "recompile", "pallas-indexmap", "pallas-ref-write"}


def test_cli_list_rules_accounts_for_every_jax_rule():
    port = _cli("--list-rules")
    jax = _jax_cli("--list-rules")
    assert port.returncode == jax.returncode == 0
    port_rules, jax_rules = set(port.stdout.split()), set(jax.stdout.split())
    assert len(jax_rules) == 18
    assert jax_rules - port_rules == NOT_PORTED
    assert port_rules - jax_rules == {"kernel-status", "kernel-fallback"}
    roadmap = (ROOT / "ROADMAP.md").read_text()
    readme = (ROOT / "README.md").read_text()
    for name in NOT_PORTED:
        assert f"`{name}`" in roadmap and f"`{name}`" in readme, name
    for name in port_rules:
        assert f"`{name}`" in readme, name


def test_cli_exit_codes(tmp_path):
    (tmp_path / "ops").mkdir()
    bad = tmp_path / "ops" / "bad.py"
    bad.write_text(_LEAK)
    proc = _cli(str(bad), "--no-baseline")
    assert proc.returncode == 1 and "[resource-leak]" in proc.stdout
    proc = _cli(str(tmp_path / "nope.py"))
    assert proc.returncode == 2
    proc = _cli("--rules", "not-a-rule", "progen_tpu_torch")
    assert proc.returncode == 2
    good = tmp_path / "good.py"
    good.write_text("def f(x):\n    return x\n")
    proc = _cli(str(good))
    assert proc.returncode == 0 and proc.stdout.strip() == "0 finding(s)"
    proc = _cli()
    assert proc.returncode == 2  # no paths


def test_cli_allow_stale(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("def g(x):\n    return x  # graftcheck: disable=resource-leak\n")
    proc = _cli(str(mod), "--no-baseline")
    assert proc.returncode == 1 and "stale-suppression" in proc.stdout
    assert proc.stdout == _jax_cli(str(mod), "--no-baseline").stdout
    assert _cli(str(mod), "--no-baseline", "--allow-stale").returncode == 0


@pytest.mark.parametrize("fmt", ["json", "sarif", "human"])
def test_cli_output_equals_the_jax_clis(tmp_path, fmt):
    bad = tmp_path / "leak.py"
    bad.write_text(_LEAK)
    port = _cli("--format", fmt, "--no-baseline", str(bad))
    jax = _jax_cli("--format", fmt, "--no-baseline", str(bad))
    assert port.returncode == jax.returncode == 1
    assert port.stdout == jax.stdout
    if fmt != "human":
        assert set(json.loads(port.stdout)) == set(json.loads(jax.stdout))


def test_cli_baseline_hides_and_update_writes(tmp_path):
    bad = tmp_path / "leak.py"
    bad.write_text(_LEAK)
    base = tmp_path / "base.json"
    proc = _cli("--update-baseline", "--baseline", str(base), str(bad))
    assert proc.returncode == 0 and base.is_file()
    proc = _cli("--baseline", str(base), str(bad))
    assert proc.returncode == 0 and "1 baselined finding(s) hidden" in proc.stdout
    proc = _cli("--baseline", str(base), "--no-baseline", str(bad))
    assert proc.returncode == 1


def _jax_cli_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("graftcheck_cli",
                                                  ROOT / "tools" / "graftcheck.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_changed_files_as_the_jax_clis(tmp_path):
    from progen_tpu_torch.analysis import __main__ as cli

    jax_cli = _jax_cli_module()
    assert cli.REPO_ROOT == ROOT
    assert cli.DEFAULT_BASELINE == ROOT / "progen_tpu_torch/analysis/baseline.json"
    plain = tmp_path / "plain"
    plain.mkdir()
    assert cli.changed_files(plain, "HEAD") is None  # no git: a full scan
    repo = tmp_path / "repo"
    repo.mkdir()

    def git(*args):
        return subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
                              cwd=repo, capture_output=True, text=True)

    assert git("init", "-q").returncode == 0
    (repo / "a.py").write_text("A = 1\n")
    git("add", "a.py")
    assert git("commit", "-qm", "seed").returncode == 0
    git("branch", "-M", "main")
    (repo / "a.py").write_text("A = 2\n")       # modified
    (repo / "b.py").write_text("B = 1\n")       # untracked
    (repo / "c.txt").write_text("not python\n")  # not .py: ignored
    for ref in ("HEAD", cli._MERGE_BASE):
        got = cli.changed_files(repo, ref)
        assert sorted(p.name for p in got) == ["a.py", "b.py"]
        assert got == jax_cli.changed_files(repo, ref)


# ---------------------------------------------------------------------------
# the gate: the port holds no finding, with an empty baseline
# ---------------------------------------------------------------------------


def test_port_wide_zero_findings_gate():
    baseline_path = ROOT / "progen_tpu_torch" / "analysis" / "baseline.json"
    assert json.loads(baseline_path.read_text()) == {"version": 1, "findings": []}
    findings = analysis.run([ROOT / "progen_tpu_torch", ROOT / "chip_smoke.py"], root=ROOT,
                            report_stale=True)
    assert not findings, "\n" + engine.format_human(findings)


def test_gate_cli_exits_zero():
    proc = _cli("progen_tpu_torch", "chip_smoke.py")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "0 finding(s)"
