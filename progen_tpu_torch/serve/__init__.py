"""Multi-process serving runtime (ported from progen_tpu/serve).

The in-process engine disaggregates prefill from decode inside one process
(``ServingEngine(disagg=True)``); this package moves the stages into
separate OS processes, each with its own CUDA context (on one card, all on
``cuda:0``):

- **prefill workers** run the bucketed prefill programs and serialize the
  resulting :class:`~progen_tpu_torch.decode.handoff.Handle`\\ s onto a
  host-side socket transport (``decode/handoff.py``'s wire format, the JAX
  package's byte for byte);
- **decode replicas** deserialize handles into the merge through
  :meth:`ServingEngine.admit_handle` (``remote_prefill=True``) and stream
  completions home;
- the **router** (in the driver process) spreads requests across the
  prefill fleet and handles across the decode replicas (longest cached
  prefix, then least outstanding tokens), sheds on deadlines, relays ack
  credits, and, with :class:`StageSupervisor`, restarts a dead stage and
  replays its in-flight requests (per-request seed determinism makes the
  replay token-identical).

Placement is invisible in the tokens: a multi-process cluster produces the
single-process engine's completions on the same request set, greedy and
sampled (``tests/test_torch_serve_multiproc.py``).

The **elastic control plane** (``control.py`` + ``policy.py``) makes the
fleet itself dynamic: SLO-burn-driven autoscaling between min/max bounds,
zero-downtime rolling weight swaps (generation-tagged), and graceful
scale-down with zero sheds that never retires the sole holder of a hot
prefix, all journaled on ``/controlz`` (``tests/test_torch_elastic.py``,
``tests/test_torch_fleetcache.py``).  A decode replica may be a
tensor-parallel GROUP of processes (``ServeCluster(tp_group=G)``, handles
as slab frames; ``tests/test_torch_serve_groups.py``).
"""

from progen_tpu_torch.serve.cluster import ServeCluster
from progen_tpu_torch.serve.control import ControlPlane
from progen_tpu_torch.serve.policy import BurnRatePolicy, PolicyInputs, ScaleDecision
from progen_tpu_torch.serve.router import Router
from progen_tpu_torch.serve.worker import build_engine_from_spec, make_spec

__all__ = [
    "BurnRatePolicy",
    "ControlPlane",
    "PolicyInputs",
    "Router",
    "ScaleDecision",
    "ServeCluster",
    "build_engine_from_spec",
    "make_spec",
]
