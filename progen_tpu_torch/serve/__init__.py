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

The elastic control plane (``ControlPlane`` and its policy classes) and
tensor-parallel replica groups are not ported yet (``ROADMAP.md`` Queue 1).
"""

from progen_tpu_torch.serve.cluster import ServeCluster
from progen_tpu_torch.serve.router import Router
from progen_tpu_torch.serve.worker import build_engine_from_spec, make_spec

__all__ = [
    "Router",
    "ServeCluster",
    "build_engine_from_spec",
    "make_spec",
]
