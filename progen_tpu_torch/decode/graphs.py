"""Captured programs: one CUDA graph per program of the serving engine's
grid (the port of the JAX engine's ahead-of-time executables,
``jit(...).lower().compile()`` in ``progen_tpu/decode/engine.py:
aot_warmup``).

A JAX program is one compiled XLA executable, dispatched once.  The port's
programs run eagerly: a decode chunk of ProGen-small is some 46,000 kernel
launches from Python, and the card waits on the host between them.  A
:class:`CapturedProgram` records a program body once as a
``torch.cuda.CUDAGraph`` and replays it, one launch from the host:

* the argument tree (dicts, lists and tuples of tensors and numpy arrays;
  the slot state's cache dicts and carry lists among them; ``None`` and
  Python scalars are constants of the program) is flattened into STATIC
  input buffers on the device, allocated once;
* the body warms up with eager calls on a side stream: the kernels' first
  ``nvcc`` build (``kernels/__init__.py``), cuBLAS's handles and workspaces
  and K3's ticket buffer come into being there, since none of them may be
  created inside a capture;
* one capture on that stream records the body on the static buffers.
  Every program of a device captures on the same side stream
  (:func:`capture_stream`): cuBLAS keeps a workspace per stream for the
  life of the process, so a stream per program would leave one behind for
  each;
* a call copies the caller's tensors (and numpy arrays, host to device)
  into the static buffers, replays, and returns CLONES of the graph's
  outputs.  The program is thus a pure function, as the eager body is: it
  never writes a tensor its caller holds and never hands out a buffer that
  the next replay overwrites, so the engine's ``self.state`` is never the
  graph's memory while a replay runs, and a failed call leaves it as it
  was.

A capture freezes every address the body reads: the static buffers, and
the weights, the LoRA bank and the draft the body finds on the engine.  A
caller that rebinds one of those captures the program again
(:meth:`CapturedProgram.recapture`); writing new values into the same
tensors (``load_state_dict``) needs nothing.  The kernels encode their TMA
descriptors from those addresses when they are captured.

The kernel wrappers count their launches in Python (``launches`` and
``*_launches`` of ``ops/cuda_attention.py``, ``ops/cuda_sgu.py`` and
``ops/cuda_paged_gate_mix.py``); a replay makes no such call.  So a program
records each counter's change during its capture, takes it back (the
capture ran nothing on the device), and adds it again after every replay:
the counters go on counting launches the device ran.

Each graph has a private memory pool.  PyTorch lets graphs share one only
when they are replayed in the order they were captured, and the engine's
admit, chunk, merge and embed programs are not, so none is shared.

On the CPU there is no graph: the same staging runs and the body is called
on the static buffers in place of the replay, so the flattening, the copies
and the clones are what the CPU tests exercise.  A capture or replay that
fails raises; nothing falls back to an eager call.

A body that writes tensors it closes over (the train step's optimizer
updates the parameters and moments in place, ``train/step.py``) cannot
take a warm-up call that is thrown away: ``take_warmup=True`` makes the
warm-up a real call on the example arguments, whose result the caller takes
from :attr:`CapturedProgram.warmup_out` in place of calling the program
for those arguments.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from progen_tpu_torch.ops import cuda_attention, cuda_paged_gate_mix, cuda_sgu

# the modules whose ``*launches`` counters a replay advances
COUNTED = (cuda_attention, cuda_sgu, cuda_paged_gate_mix)


# ------------------------------------------------------------------ trees


def flatten(tree) -> tuple[list, Any]:
    """``(leaves, spec)`` of an argument tree: the tensors and numpy arrays
    in order (dict keys sorted), and a hashable description of the rest,
    constants included.  Two trees with equal specs have leaves that pair
    up one to one."""
    leaves: list = []

    def walk(node):
        if isinstance(node, (torch.Tensor, np.ndarray)):
            leaves.append(node)
            return "*"
        if isinstance(node, dict):
            return ("dict", tuple((k, walk(node[k])) for k in sorted(node)))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(walk(v) for v in node))
        return ("const", node)

    return leaves, walk(tree)


def unflatten(spec, leaves) -> Any:
    """The tree of ``spec`` (from :func:`flatten`) with ``leaves`` (an
    iterable, consumed in order) in place of its tensors."""
    it = iter(leaves)

    def build(s):
        if s == "*":
            return next(it)
        kind, items = s
        if kind == "dict":
            return {k: build(v) for k, v in items}
        if kind == "list":
            return [build(v) for v in items]
        if kind == "tuple":
            return tuple(build(v) for v in items)
        return items  # a constant

    return build(spec)


# --------------------------------------------------------------- counters


def launch_counts() -> dict:
    """Every kernel launch counter of :data:`COUNTED`, flat: ``(module,
    attr, None)`` for an int counter, ``(module, attr, key)`` for each
    entry of a per-route dict."""
    out = {}
    for module in COUNTED:
        for attr, value in vars(module).items():
            if not attr.endswith("launches"):
                continue
            if isinstance(value, dict):
                out.update({(module, attr, k): n for k, n in value.items()})
            elif isinstance(value, int):
                out[(module, attr, None)] = value
    return out


def counts_since(before: dict) -> dict:
    """What each counter gained since ``before`` (:func:`launch_counts`)."""
    now = launch_counts()
    return {k: n - before.get(k, 0) for k, n in now.items() if n != before.get(k, 0)}


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign * delta`` to the counters (read afresh: a caller may have
    replaced a per-route dict by a new one since ``delta`` was taken)."""
    for (module, attr, key), n in delta.items():
        if key is None:
            setattr(module, attr, getattr(module, attr) + sign * n)
        else:
            table = getattr(module, attr)
            table[key] = table.get(key, 0) + sign * n


# ----------------------------------------------------------------- program


_streams: dict[torch.device, torch.cuda.Stream] = {}


def capture_stream(device) -> torch.cuda.Stream:
    """The side stream every capture on ``device`` warms up and records on."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf


class CapturedProgram:
    """``fn`` captured on static buffers shaped as ``example_args``; a
    call ``program(*args)`` with args of the same tree, shapes and dtypes
    returns what ``fn(*args)`` returns, as fresh tensors.

    ``device``: where the static buffers live; on ``cuda`` the body is
    warmed up by one eager call on the side stream and captured once, on
    the CPU it is called on every call.  ``launches`` is the counters'
    change one replay stands for (empty on the CPU, where the body counts
    for itself).  ``take_warmup``: keep the warm-up call's result as
    :attr:`warmup_out` (None on the CPU, where nothing is warmed up)."""

    def __init__(self, fn: Callable, *example_args, device, take_warmup: bool = False):
        self.fn = fn
        self.device = torch.device(device)
        self._take_warmup = take_warmup
        self.warmup_out = None
        leaves, self._in_spec = flatten(example_args)
        self._static = [torch.empty(tuple(t.shape), dtype=t.dtype, device=self.device)
                        for t in map(_as_tensor, leaves)]
        self._stage(leaves)
        self._graph: torch.cuda.CUDAGraph | None = None
        self._out: list[torch.Tensor] = []
        self._out_spec = None
        self.launches: dict = {}
        if self.device.type == "cuda":
            self._capture()

    @property
    def captured(self) -> bool:
        return self._graph is not None

    @property
    def host_launches(self) -> int:
        """What one call of a captured program puts on the device from the
        host: a copy per argument leaf, the replay, a clone per output."""
        return len(self._static) + 1 + len(self._out)

    def _args(self):
        return unflatten(self._in_spec, self._static)

    def _stage(self, leaves) -> None:
        """Copy the call's leaves into the static buffers (numpy arrays host
        to device); a leaf of another shape or dtype raises."""
        for i, (dst, leaf) in enumerate(zip(self._static, leaves)):
            src = _as_tensor(leaf)
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"argument leaf {i}: {tuple(src.shape)} {src.dtype}, the "
                    f"program was captured for {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)

    def _capture(self) -> None:
        stream = capture_stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            out = self.fn(*self._args())
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(stream)
        if self._take_warmup:
            leaves, _ = flatten(out)
            for t in leaves:  # made on the side stream, read on this one
                t.record_stream(current)
            self.warmup_out = out
        del out
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.graph(graph, stream=stream):
                out = self.fn(*self._args())
        finally:
            # the capture ran nothing: what it counted, each replay adds
            self.launches = counts_since(before)
            add_counts(self.launches, sign=-1)
        self._out, self._out_spec = flatten(out)
        self._graph = graph

    def recapture(self) -> None:
        """Capture the body again on the same static buffers, after it
        came to read other tensors (a rebound model, draft or bank).  The
        old graph and its pool go first."""
        self._graph, self._out, self._out_spec = None, [], None
        if self.device.type == "cuda":
            self._capture()

    def __call__(self, *args):
        leaves, spec = flatten(args)
        if spec != self._in_spec:
            raise ValueError("the arguments' structure or constants differ from "
                             "the ones the program was captured with")
        self._stage(leaves)
        if self._graph is None:
            out, out_spec = flatten(self.fn(*self._args()))
        else:
            self._graph.replay()
            add_counts(self.launches)
            out, out_spec = self._out, self._out_spec
        return unflatten(out_spec, [t.clone() for t in out])
