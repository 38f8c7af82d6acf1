"""Rule ``trace-safety``: host-side impurities inside captured code.

The counterpart of ``progen_tpu/analysis/rules_trace.py``, on CUDA-graph
capture in place of tracing.  A captured body runs its Python once, at
capture; every replay runs only what it launched.  So ``print`` prints
once, ``time.*`` is a constant of the capture, and ``random.*`` /
``np.random.*`` draw one host value that every replay reuses.  Flag them
only in code the per-module capture graph (``capturegraph.py``) proves
captured: the bodies handed to ``CapturedProgram`` and what they call,
and the statements under ``with torch.cuda.graph(...)``.  Host driver
code (the engine's step, the training loop, the CLIs) may use them
freely.
"""

from __future__ import annotations

import ast

from progen_tpu_torch.analysis.capturegraph import call_name, capture_graph, own_nodes
from progen_tpu_torch.analysis.engine import Finding, ParsedModule, RepoContext, rule

_BAD_PREFIXES = ("random.", "np.random.", "numpy.random.", "time.")

_SUGGESTION = {
    "print": "a captured body prints once, at capture; print outside the "
             "program, from its outputs",
    "time": "host clocks are constants of the capture; time the replay "
            "outside the captured body",
    "random": "a host draw is a constant of the capture; draw on the "
              "device from an explicit generator or key passed in",
}


def _suggest(name: str) -> str:
    if name == "print":
        return _SUGGESTION["print"]
    if name.startswith("time."):
        return _SUGGESTION["time"]
    return _SUGGESTION["random"]


def _bad(name: str | None) -> bool:
    return name is not None and (
        name == "print" or any(name.startswith(p) for p in _BAD_PREFIXES))


@rule("trace-safety")
def check(module: ParsedModule, ctx: RepoContext):
    graph = capture_graph(module.tree)
    scopes = [(fn, f"captured function '{fn.name}'", own_nodes(fn))
              for fn in graph.captured]
    scopes += [(region, "a 'with torch.cuda.graph' region",
                graph.region_nodes(region)) for region, _ in graph.regions]
    for _, where, nodes in scopes:
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if _bad(name):
                yield Finding(
                    rule="trace-safety",
                    path=module.path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=f"'{name}' called inside {where}: {_suggest(name)}",
                )
