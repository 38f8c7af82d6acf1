"""graftcheck for the port: static analysis of ``progen_tpu_torch``.

The counterpart of ``progen_tpu/analysis``.  Pure stdlib: it imports
neither torch nor jax nor anything of ``progen_tpu``, and never executes
the code it reads.  Its framework-neutral passes (the engine, the CFG and
dataflow, ``resource-leak``, the ``wire-*`` and ``det-*`` rules) are
copies of the JAX package's, pinned to them by
``tests/test_torch_analysis.py``; its JAX-specific rules have torch
counterparts under the same names (``trace-safety`` and ``host-sync``
over CUDA-graph capture, ``rng-*`` over the port's key chain, ``dtype-*``
over torch's precision switches and bf16 spellings, ``mesh-axis`` over
``DeviceMesh`` lookups) and ``rules_pallas`` has the port's kernel class
(``kernel-status``, ``kernel-fallback``).  Entry points:

* ``python -m progen_tpu_torch.analysis`` — the CLI, with the flags and
  exit codes of ``tools/graftcheck.py``
* :func:`progen_tpu_torch.analysis.engine.run` — programmatic, used by
  the zero-findings gate test
* :func:`progen_tpu_torch.analysis.engine.check_source` — single-snippet
  checks, used by the per-rule unit tests

Rules register themselves into ``engine.RULES`` when their module is
imported; :func:`load_rules` imports them all.
"""

from __future__ import annotations

import importlib

from progen_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    RULES,
    apply_baseline,
    build_context,
    check_source,
    format_human,
    format_json,
    format_sarif,
    load_baseline,
    run,
    save_baseline,
)

_RULE_MODULES = (
    "rules_trace",
    "rules_rng",
    "rules_dtype",
    "rules_sharding",
    "rules_hostsync",
    "rules_kernel",
    "rules_lifecycle",
    "rules_wire",
    "rules_determinism",
)


def load_rules() -> dict:
    for mod in _RULE_MODULES:
        importlib.import_module(f"progen_tpu_torch.analysis.{mod}")
    return RULES
