"""Prefill -> decode handoff: cache handles over a bounded queue
(ported from progen_tpu/decode/handoff.py).

Disaggregated serving splits the engine's step into a PREFILL stage and a
DECODE stage.  The prefill worker runs the bucketed parallel prefill on its
own and produces a :class:`Handle`: a self-contained slab of per-row decode
state (caches, the sequence row with its first sampled token, position,
stop, key and sampling knobs) for up to ``prefill_batch`` requests, shaped
``(num_slots, ...)``, which the decode stage's merge gathers into free
slots.

The queue between the stages is BOUNDED (``handoff_depth`` handles): a full
queue skips the prefill round (backpressure: prefilled state is the
expensive thing to hold), while :meth:`HandoffQueue.requeue` puts a handle
back at the FRONT after a transiently failed merge without counting against
the bound (the handle was already admitted once; a crash-replay loop must
not deadlock against its own backpressure).

The queue is host-side bookkeeping only: handles carry device tensors, and
nothing here reads them.  :class:`Handle` and :class:`HandoffQueue` are
copied from the JAX module (standard library only).

The module-level ``serialize_handle`` / ``deserialize_handle`` below are
the opposite: they ARE the cross-process transport of the serving fleet
(``serve/``) and wait for the device by design (one device-to-host copy on
send, one host-to-device copy on receive).  They run on a worker's loop
between dispatches, never inside one.

Wire format (one handle = one frame), the JAX package's byte for byte::

    <4sHHIQII> prefix (28 bytes, little-endian):
        magic  b"PGHF" | version u16 | reserved u16
        header_len u32 | payload_len u64
        header_crc u32 | payload_crc u32 (zlib.crc32)
    header: UTF-8 JSON: request rows, p_pad, and a manifest of
        (path, dtype, shape, offset, nbytes) per state leaf
    payload: the raw tensor bytes, concatenated at manifest offsets

The state crosses under JAX's leaf paths (sorted keys, ``#i`` for a list
index, ``@i`` for a tuple's) and in JAX's dtypes, named as numpy names
them, so a frame of either package is read by the other: the port holds
the key chain (``keys``) and the LoRA row (``tenant``) as int64, and they
travel as JAX's uint32 and int32 (:data:`WIRE_DTYPES`).  ``bfloat16`` is
mapped through ``torch.bfloat16``; nothing here needs numpy's extension
types.

A payload CRC mismatch raises :class:`FrameCorrupt`: the prefix and header
survived, so the stream is still framed and the router can shed or replay
exactly the requests named in the header.  A bad magic or version or a
truncated read raises :class:`FrameDesync`: the stream can no longer be
trusted and the connection is poisoned (the supervisor restarts the
stage).  Both are typed: a corrupt frame sheds, never crashes.

A decode replica that is a tensor-parallel GROUP of ``G`` processes
(``serve/worker.py``) gets each handle as ``G`` slab frames: the driver
splits a frame with :func:`split_handle_frame` (the JAX package's bytes,
one shard's slice of every leaf :func:`slab_axis` splits, the rest whole,
each frame with its own CRC), and each member rebuilds its part of the
state with :func:`deserialize_handle_sharded`: one all-gather of the slab
payloads over the group, then the rank's part of each leaf in the layout
its engine holds (:func:`rank_axis`: a k/v ring's heads, a gate row's
channels; everything else whole), in ONE host-to-device copy.

The wire half is ported from ``progen_tpu/decode/handoff.py:141-392`` and
``:527-576``, the slab half from ``:393-526``.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import time
import warnings
import zlib
from collections import deque
from typing import Any, Sequence

import torch

from progen_tpu_torch.observe import trace as _trace


@dataclasses.dataclass
class Handle:
    """One prefill worker product awaiting decode admission.

    ``requests``: the admitted requests in row order (row ``i`` of the
    state slabs belongs to ``requests[i]``; later rows are dummy).
    ``state``: device tensors, ``(num_slots, ...)``-shaped: seq, caches
    (dense gate rows even in paged mode; the merge scatters them into
    the pool), pos/start/stop/done/keys/top_k/temp/lmask, plus draft
    caches under speculative decoding.  ``p_pad``: the prefill bucket that
    produced it (the merge does not depend on it).
    """

    requests: list
    state: dict[str, Any]
    p_pad: int


class HandoffQueue:
    """Bounded FIFO of :class:`Handle`\\ s between the serving stages."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"handoff depth must be >= 1, got {depth}")
        self.depth = depth
        self._q: deque[Handle] = deque()
        self.puts = 0
        self.gets = 0
        self.rejects = 0

    def full(self) -> bool:
        return len(self._q) >= self.depth

    def put(self, handle: Handle) -> bool:
        """Append; False (and a ``rejects`` tick) when at depth: the
        caller should have checked :meth:`full` before paying for the
        prefill, so a reject indicates lost work."""
        if self.full():
            self.rejects += 1
            return False
        self._q.append(handle)
        self.puts += 1
        return True

    def requeue(self, handle: Handle) -> None:
        """Return a handle to the FRONT (failed merge retry path); not
        depth-bounded, see the module docstring."""
        self._q.appendleft(handle)

    def get(self) -> Handle:
        self.gets += 1
        return self._q.popleft()

    def peek(self) -> Handle:
        return self._q[0]

    def num_requests(self) -> int:
        """Requests captured in queued handles."""
        return sum(len(h.requests) for h in self._q)

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def stats(self) -> dict:
        return {"depth": self.depth, "queued": len(self._q),
                "puts": self.puts, "gets": self.gets,
                "rejects": self.rejects}


# --------------------------------------------------------------- wire format
#
# Transport layer: everything below waits for the device; it runs between a
# worker's dispatches only (see the module docstring).

FRAME_MAGIC = b"PGHF"
FRAME_VERSION = 1
_PREFIX = struct.Struct("<4sHHIQII")
FRAME_PREFIX_LEN = _PREFIX.size  # 28

# leaves the port holds in another dtype than JAX's, by their last path
# segment: the wire carries JAX's (numpy's name), the port's comes back
WIRE_DTYPES = {"keys": "uint32", "tenant": "int32"}
_PORT_DTYPES = {"keys": torch.int64, "tenant": torch.int64}

# numpy's dtype names, as the JAX package writes them in a manifest
_TORCH_DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}
_UINT32 = 0xFFFFFFFF


class FrameError(Exception):
    """A frame failed to decode.  Never escapes the serving runtime as a
    crash: subclasses pick the recovery (shed vs restart)."""


class FrameCorrupt(FrameError):
    """Payload CRC mismatch with an intact prefix+header: the stream is
    still framed; shed or replay the requests named in the header and keep
    the connection."""

    def __init__(self, msg: str, header: dict | None = None):
        super().__init__(msg)
        self.header = header


class SlabDropped(FrameCorrupt):
    """This member's slab was sound, but another member of its replica
    group could not read its own slab of the batch: the group drops the
    batch as one (:func:`deserialize_handle_sharded`'s vote)."""


class FrameDesync(FrameError):
    """Bad magic/version, header corruption, or a truncated read: the byte
    stream can no longer be trusted; poison the connection and let stage
    supervision restart the peer."""


def pack_frame(header: dict, payload_parts: Sequence = ()) -> bytes:
    """Assemble one wire frame from a JSON-able header and raw payload
    parts (bytes-likes, concatenated in order)."""
    hdr = json.dumps(header, separators=(",", ":")).encode()
    parts = [memoryview(p).cast("B") for p in payload_parts]
    payload_len = sum(p.nbytes for p in parts)
    payload_crc = 0
    for p in parts:
        payload_crc = zlib.crc32(p, payload_crc)
    out = bytearray(_PREFIX.size + len(hdr) + payload_len)
    _PREFIX.pack_into(out, 0, FRAME_MAGIC, FRAME_VERSION, 0, len(hdr),
                      payload_len, zlib.crc32(hdr), payload_crc)
    out[_PREFIX.size:_PREFIX.size + len(hdr)] = hdr
    off = _PREFIX.size + len(hdr)
    for p in parts:
        out[off:off + p.nbytes] = p
        off += p.nbytes
    return bytes(out)


def parse_prefix(prefix: bytes) -> tuple[int, int, int, int]:
    """Validate a 28-byte frame prefix; returns ``(header_len,
    payload_len, header_crc, payload_crc)``.  :class:`FrameDesync` on a
    short read, bad magic, or unknown version."""
    if len(prefix) < _PREFIX.size:
        raise FrameDesync(
            f"truncated frame prefix: {len(prefix)} < {_PREFIX.size} bytes")
    magic, version, _, hlen, plen, hcrc, pcrc = _PREFIX.unpack_from(prefix)
    if magic != FRAME_MAGIC:
        raise FrameDesync(f"bad frame magic {magic!r}")
    if version != FRAME_VERSION:
        raise FrameDesync(f"unsupported frame version {version}")
    return hlen, plen, hcrc, pcrc


def unpack_frame(buf) -> tuple[dict, memoryview]:
    """Split one complete frame back into ``(header, payload_view)``.

    ``payload_view`` is a zero-copy view into ``buf``.  Raises
    :class:`FrameDesync` (untrustworthy stream) or :class:`FrameCorrupt`
    (payload CRC with a good header: ``.header`` names the casualties).
    """
    view = memoryview(buf).cast("B")
    hlen, plen, hcrc, pcrc = parse_prefix(bytes(view[:_PREFIX.size]))
    end = _PREFIX.size + hlen + plen
    if view.nbytes < end:
        raise FrameDesync(
            f"truncated frame: have {view.nbytes} bytes, need {end}")
    hdr_bytes = view[_PREFIX.size:_PREFIX.size + hlen]
    if zlib.crc32(hdr_bytes) != hcrc:
        raise FrameDesync("frame header CRC mismatch")
    try:
        header = json.loads(bytes(hdr_bytes))
    except ValueError as e:
        raise FrameDesync(f"frame header is not JSON: {e}") from e
    payload = view[_PREFIX.size + hlen:end]
    if zlib.crc32(payload) != pcrc:
        raise FrameCorrupt("frame payload CRC mismatch", header=header)
    return header, payload


def _flatten_state(state, prefix: str = "") -> list:
    """Deterministic (sorted-key, '/'-joined path) flatten of a handle
    state tree into ``[(path, leaf), ...]``.  List/tuple nodes (the
    per-layer cache lists) use ``#i``/``@i`` index segments so the receiver
    rebuilds the exact container types."""
    out = []
    if isinstance(state, dict):
        items = [(str(k), state[k]) for k in sorted(state)]
    elif isinstance(state, (list, tuple)):
        marker = "#" if isinstance(state, list) else "@"
        items = [(f"{marker}{i}", v) for i, v in enumerate(state)]
    else:
        raise TypeError(f"unsupported state node {type(state).__name__}")
    for k, v in items:
        path = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.extend(_flatten_state(v, prefix=path + "/"))
        else:
            out.append((path, v))
    return out


def _unflatten_state(pairs) -> dict:
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return _rebuild_containers(tree)


def _rebuild_containers(node):
    """Turn ``#i``/``@i``-keyed dicts from :func:`_unflatten_state` back
    into lists/tuples, depth-first."""
    if not isinstance(node, dict):
        return node
    rebuilt = {k: _rebuild_containers(v) for k, v in node.items()}
    if rebuilt and all(k[:1] in "#@" and k[1:].isdigit() for k in rebuilt):
        marker = next(iter(rebuilt))[0]
        seq = [rebuilt[f"{marker}{i}"] for i in range(len(rebuilt))]
        return tuple(seq) if marker == "@" else seq
    return rebuilt


def request_to_wire(r, *, now: float | None = None) -> dict:
    """Host-side request row for a frame header.  ``perf_counter`` instants
    do not cross processes, so an absolute deadline travels as its
    REMAINING budget (as ``ServingEngine._snap_request`` keeps it)."""
    if now is None:
        now = time.perf_counter()
    entry = {
        "uid": r.uid,
        "tokens": [int(t) for t in r.tokens],
        "max_new_tokens": int(r.max_new_tokens),
        "top_k": None if r.top_k is None else int(r.top_k),
        "temperature": float(r.temperature),
        "seed": int(r.seed),
        # trace context: the per-request trace id (its uid) plus the
        # sender's clock instant, so the receiving process can attribute
        # queue-wait to this request on an offset-corrected timeline
        "trace": {"id": r.uid, "clock": now},
    }
    if getattr(r, "logit_mask", None) is not None:
        from progen_tpu_torch.workloads.infill import mask_to_wire
        entry["logit_mask"] = mask_to_wire(r.logit_mask)
    tenant = int(getattr(r, "tenant", 0))
    if tenant != 0:
        entry["tenant"] = tenant
    priority = int(getattr(r, "priority", 0))
    if priority != 0:
        entry["priority"] = priority
    deadline = r.deadline
    if deadline is None and r.ttl is not None:
        deadline = r.submit_time + r.ttl
    if deadline is not None:
        entry["deadline_remaining"] = max(0.0, deadline - now)
    return entry


def request_from_wire(d: dict, *, now: float | None = None,
                      on_complete=None, vocab: int | None = None):
    """Rebuild a :class:`~progen_tpu_torch.decode.engine.Request` in the
    receiving process; the deadline resumes from its remaining budget.
    ``vocab`` sizes a decoded infill mask (required when one rides)."""
    from progen_tpu_torch.decode.engine import Request

    if now is None:
        now = time.perf_counter()
    lmask = None
    if d.get("logit_mask") is not None:
        if vocab is None:
            raise ValueError("request carries a logit_mask but the "
                             "receiver passed no vocab size")
        from progen_tpu_torch.workloads.infill import mask_from_wire
        lmask = mask_from_wire(d["logit_mask"], vocab)
    r = Request(
        uid=d["uid"], tokens=list(d["tokens"]),
        max_new_tokens=int(d["max_new_tokens"]),
        top_k=d.get("top_k"), temperature=float(d.get("temperature", 1.0)),
        seed=int(d.get("seed", 0)), on_complete=on_complete,
        submit_time=now, logit_mask=lmask, tenant=int(d.get("tenant", 0)),
        priority=int(d.get("priority", 0)))
    if "deadline_remaining" in d:
        r.deadline = now + float(d["deadline_remaining"])
    tc = d.get("trace")
    if tc:
        # land the sender's clock instant on this process's timeline so the
        # offset-corrected merge can attribute cross-process queue wait to
        # the request
        _trace.get_tracer().event("request.arrive", trace=tc.get("id"),
                                  sender_clock=tc.get("clock"),
                                  recv_clock=now)
    return r


def _to_wire(path: str, leaf: torch.Tensor) -> tuple[str, torch.Tensor]:
    """A state leaf in its wire dtype: ``(numpy name, tensor)``, on the
    leaf's device.  A uint32 leaf travels as the int32 of the same bits
    (PyTorch has no uint32 arithmetic on every device)."""
    name = WIRE_DTYPES.get(path.rsplit("/", 1)[-1])
    if name is None:
        if leaf.dtype not in _NAMES or leaf.dtype == torch.int64:
            raise TypeError(f"handle leaf {path!r} of dtype {leaf.dtype} has "
                            f"no wire dtype")
        return _NAMES[leaf.dtype], leaf
    t = leaf.to(torch.int64)
    if name == "uint32":
        t = torch.where(t > 0x7FFFFFFF, t - (1 << 32), t)
    return name, t.to(torch.int32)


def _wire_typed(name: str, raw: torch.Tensor) -> torch.Tensor:
    """The bytes ``raw`` (uint8) as the tensor dtype that holds wire dtype
    ``name`` (a uint32 as the int32 of the same bits)."""
    if name == "uint32":
        return _view(raw, torch.int32)
    if name in _TORCH_DTYPES:
        return _view(raw, _TORCH_DTYPES[name])
    raise ValueError(f"unknown wire dtype {name!r}")


def _to_port(path: str, name: str, t: torch.Tensor) -> torch.Tensor:
    """A leaf of wire dtype ``name`` (as :func:`_wire_typed` holds it) in the
    port's dtype for ``path``."""
    if name == "uint32":
        t = t.to(torch.int64) & _UINT32
    want = _PORT_DTYPES.get(path.rsplit("/", 1)[-1])
    if want is not None and t.dtype != want:
        t = t.to(want)
    return t


def _from_wire(path: str, name: str, raw: torch.Tensor, shape) -> torch.Tensor:
    """The bytes ``raw`` (uint8, on the engine's device) as the port's leaf
    at ``path``."""
    return _to_port(path, name, _wire_typed(name, raw)).reshape(shape)


def _view(raw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``raw`` reinterpreted as ``dtype``; a slice that does not start on a
    16-byte boundary is copied first (the kernels take aligned tensors, and
    a wider view needs an offset that is a multiple of its width)."""
    if raw.storage_offset() % 16:
        raw = raw.clone()
    return raw.view(dtype)


def serialize_handle(handle: Handle, *, extra_header: dict | None = None,
                     counters=None) -> bytes:
    """One prefill product -> one wire frame.

    Every leaf is cast to its wire dtype and its bytes concatenated ON THE
    DEVICE, so the whole tree comes to the host in ONE copy (one wait, not
    one per leaf); the header records ``(path, dtype, shape, offset,
    nbytes)`` so the receiver can rebuild the tree from views into the
    buffer.  ``extra_header`` keys (batch ids, routing tags) are merged
    into the header verbatim.
    """
    t0 = time.perf_counter()
    pairs = _flatten_state(handle.state)
    manifest = []
    parts = []
    off = 0
    for path, leaf in pairs:
        name, t = _to_wire(path, leaf)
        t = t.contiguous()
        nbytes = t.numel() * t.element_size()
        manifest.append([path, name, list(t.shape), off, nbytes])
        parts.append(t.reshape(-1).view(torch.uint8))
        off += nbytes
    host = torch.cat(parts).cpu() if parts else torch.zeros(0, dtype=torch.uint8)
    header = {
        "type": "handle",
        "p_pad": int(handle.p_pad),
        "reqs": [request_to_wire(r) for r in handle.requests],
        "manifest": manifest,
    }
    if extra_header:
        header.update(extra_header)
    frame = pack_frame(header, [host.numpy()])
    dt = time.perf_counter() - t0
    if counters is not None:
        counters.ser_s += dt
    _trace.get_tracer().add("handoff.serialize", t0, dt,
                            uids=[r.uid for r in handle.requests],
                            nbytes=len(frame))
    return frame


def deserialize_handle(buf, *, header: dict | None = None, payload=None,
                       counters=None, device=None) -> Handle:
    """One wire frame -> a :class:`Handle` of fresh tensors on ``device``
    (the CPU by default; a replica passes its engine's device).

    Pass either the full frame ``buf`` or a pre-unpacked ``(header,
    payload)`` pair (the router parses headers without touching payloads).
    The payload is taken as one ``torch.frombuffer`` view of the received
    buffer and copied to the device in ONE host-to-device copy; each
    manifest entry is then a view into that copy (re-typed where the port
    holds another dtype).  The tensors are the handle's own: the merge only
    reads them and they are released with the handle.
    """
    t0 = time.perf_counter()
    if header is None:
        header, payload = unpack_frame(buf)
    view = memoryview(payload).cast("B")
    try:
        with warnings.catch_warnings():
            # a received frame is immutable bytes; the copy below is ours
            warnings.simplefilter("ignore", UserWarning)
            host = (torch.frombuffer(view, dtype=torch.uint8) if view.nbytes
                    else torch.zeros(0, dtype=torch.uint8))
        dev = host.to(device or "cpu", copy=True)
        pairs = []
        for path, dtype, shape, off, nbytes in header["manifest"]:
            if off < 0 or off + nbytes > view.nbytes:
                raise ValueError(f"leaf {path!r} runs past the payload")
            pairs.append((path, _from_wire(path, dtype, dev[off:off + nbytes],
                                           tuple(shape))))
        # an infill request's mask rides its row; its vocabulary is the
        # lmask leaf's last axis (the JAX reader passes none, and raises on
        # such a frame)
        vocab = next((shape[-1] for path, _, shape, _, _ in header["manifest"]
                      if path == "lmask"), None)
        reqs = [request_from_wire(d, vocab=vocab) for d in header["reqs"]]
        p_pad = int(header["p_pad"])
    except (KeyError, TypeError, ValueError, RuntimeError) as e:
        raise FrameCorrupt(f"malformed handle header: {e}",
                           header=header) from e
    h = Handle(requests=reqs, state=_unflatten_state(pairs), p_pad=p_pad)
    dt = time.perf_counter() - t0
    if counters is not None:
        counters.de_s += dt
    _trace.get_tracer().add("handoff.deserialize", t0, dt,
                            uids=[r.uid for r in reqs])
    return h


# ------------------------------------------------------------ slab frames
#
# A tensor-parallel decode replica is a group of processes; each gets its
# own slab of every handle (serve/cluster.py splits, serve/worker.py reads).

# bytes an element of each wire dtype takes (the split moves bytes only)
_ITEMSIZE = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "float16": 2,
             "bfloat16": 2, "int32": 4, "uint32": 4, "float32": 4,
             "int64": 8, "float64": 8}


def slab_axis(path: str, shape, group_size: int) -> int | None:
    """The slab rule for tensor-parallel decode groups: which axis of a
    handle-state leaf is split across the group's shards (the JAX
    package's rule, so the frames are its bytes).

    One pure function IS the wire contract: the driver applies it when
    fanning a prefill frame out into per-shard slabs, and every member
    applies the inverse when it rebuilds its part.  Rule: a leaf of rank
    >= 2 whose LAST axis divides by ``group_size`` splits on that axis;
    everything else replicates.  ``path`` is part of the signature so a
    future format revision can special-case leaves without changing call
    sites.
    """
    del path  # today's rule is shape-only; see docstring
    if group_size <= 1 or len(shape) < 2:
        return None
    last = len(shape) - 1
    if shape[last] >= group_size and shape[last] % group_size == 0:
        return last
    return None


def split_handle_frame(header: dict, payload, group_size: int) -> list[bytes]:
    """Fan one full handle frame out into ``group_size`` per-shard slab
    frames for a multi-process tensor-parallel decode replica.

    Numpy on the already-received payload bytes (each leaf as unsigned
    integers of its element's width: the slices move bytes, whatever the
    dtype), no tensor and no device work; this runs on the driver's relay
    path.  Every slab frame carries the SAME header (requests, batch id,
    routing tags) plus a ``slab`` section naming this shard's rank, the
    group size and the per-leaf split axes; its manifest describes the
    shard's slab shapes, so :func:`unpack_frame` parses it like any other
    frame.  Byte for byte the JAX package's frames.
    """
    import numpy as np

    if group_size <= 1:
        raise ValueError(f"group_size must be > 1, got {group_size}")
    view = memoryview(payload).cast("B")
    leaves = []
    split: dict[str, int] = {}
    for path, dtype, shape, off, nbytes in header["manifest"]:
        arr = np.frombuffer(view[off:off + nbytes],
                            dtype=np.dtype(f"u{_ITEMSIZE[dtype]}")).reshape(shape)
        axis = slab_axis(path, shape, group_size)
        if axis is not None:
            split[path] = axis
        leaves.append((path, dtype, arr, axis))
    base = {k: v for k, v in header.items() if k != "manifest"}
    frames = []
    for shard in range(group_size):
        manifest = []
        parts = []
        off = 0
        for path, dtype, arr, axis in leaves:
            if axis is None:
                part = arr
            else:
                w = arr.shape[axis] // group_size
                sl = [slice(None)] * arr.ndim
                sl[axis] = slice(shard * w, (shard + 1) * w)
                part = np.ascontiguousarray(arr[tuple(sl)])
            manifest.append([path, dtype, list(part.shape), off, part.nbytes])
            parts.append(memoryview(
                np.ascontiguousarray(part).reshape(-1).view(np.uint8)))
            off += part.nbytes
        hdr = dict(base)
        hdr["manifest"] = manifest
        hdr["slab"] = {"shard": shard, "group_size": group_size, "split": split}
        frames.append(pack_frame(hdr, parts))
    return frames


def rank_axis(path: str, draft_whole: bool = False) -> int | None:
    """The axis of a handle-state leaf of which a tensor-parallel rank of
    the port holds its part (the rank-width caches of decode under a mesh,
    ``parallel/decode.py``): the heads of a k/v ring (axis 1), the channels
    of a gate row (the last); ``None``: the rank holds the leaf whole.
    ``draft_whole``: the speculative draft is a model of its own, whole on
    every rank with whole caches."""
    parts = path.split("/")
    if parts[0] == "caches" or (parts[0] == "draft_caches" and not draft_whole):
        if parts[1] in ("k", "v"):
            return 1
        if parts[1] == "sgu_gate":
            return -1
    return None


def group_device(group=None) -> torch.device:
    """Where the collectives of ``group`` (default: the process group) take
    their tensors: the card under NCCL, the host under gloo (which takes
    host tensors as they are)."""
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def deserialize_handle_sharded(buf, mesh, *, header: dict | None = None,
                               payload=None, counters=None, device=None,
                               vote=None, draft_whole: bool = False) -> Handle:
    """One per-shard slab frame -> a :class:`Handle` of this rank's state
    on ``device``, for the engine of one member of a tensor-parallel decode
    group (``mesh``: the group's mesh, or decode's view of it; its
    ``tensor`` dim is the group, and slab ``k`` is tensor rank ``k``'s).

    The counterpart of the JAX package's reader, which rebuilds global
    arrays over the group's mesh: here the members all-gather their slab
    payloads once over the ``tensor`` group (on the host under gloo), put
    each split leaf back together, and keep what the rank's engine holds
    (:func:`rank_axis`: its heads of a k/v ring, its channels of a gate
    row, every other leaf whole).  The rank's leaves are packed into one
    buffer and copied to ``device`` in ONE host-to-device copy; each leaf
    is a view into it (re-typed where the port holds another dtype).

    ``vote`` (``ok -> all_ok``, a collective over the group) runs after
    this member parsed its slab and before any other collective: a slab
    that fails its CRC or its header on ANY member raises
    :class:`FrameCorrupt` on every member (:class:`SlabDropped` on those
    whose own slab was sound), so the group drops the batch as one.  Pass
    either the slab frame ``buf`` or its unpacked ``(header,
    payload)``.
    """
    import torch.distributed as dist

    from progen_tpu_torch.parallel.tensor import tensor_split

    t0 = time.perf_counter()
    ranks, group = tensor_split(mesh)
    me = mesh.get_local_rank("tensor") if ranks > 1 else 0
    err = None
    try:
        if header is None:
            header, payload = unpack_frame(buf)
        slab = header.get("slab") or {}
        if int(slab.get("group_size", 1)) != ranks or int(slab.get("shard", 0)) != me:
            raise ValueError(f"slab {slab.get('shard')} of {slab.get('group_size')} "
                             f"reached tensor rank {me} of {ranks}")
        split = {k: int(v) for k, v in (slab.get("split") or {}).items()}
        view = memoryview(payload).cast("B")
        entries = []
        for path, dtype, shape, off, nbytes in header["manifest"]:
            if off < 0 or off + nbytes > view.nbytes or dtype not in _ITEMSIZE:
                raise ValueError(f"leaf {path!r} runs past the payload or has "
                                 f"dtype {dtype!r}")
            entries.append((path, dtype, tuple(shape), off, nbytes))
        # the vocabulary of an infill request's mask: the lmask leaf's
        # last axis, whole (split or not)
        vocab = next((shape[-1] * (ranks if path in split else 1)
                      for path, _, shape, _, _ in entries if path == "lmask"), None)
        reqs = [request_from_wire(d, vocab=vocab) for d in header["reqs"]]
        p_pad = int(header["p_pad"])
    except FrameCorrupt as e:
        err = e
    except (KeyError, TypeError, ValueError) as e:
        err = FrameCorrupt(f"malformed slab frame header: {e}", header=header)
    if vote is not None and not vote(err is None):
        raise err or SlabDropped("another member of the group could not read "
                                 "its slab of this batch", header=header)
    if err is not None:
        raise err
    comm = group_device(group) if group is not None else torch.device("cpu")
    with warnings.catch_warnings():
        # a received frame is immutable bytes; the copy below is ours
        warnings.simplefilter("ignore", UserWarning)
        local = (torch.frombuffer(view, dtype=torch.uint8) if view.nbytes
                 else torch.zeros(0, dtype=torch.uint8))
    local = local.to(comm, copy=True)
    if group is not None:
        slabs = [torch.empty_like(local) for _ in range(ranks)]
        dist.all_gather(slabs, local, group=group)
    else:
        slabs = [local]
    # the rank's leaves, in the wire's dtypes, packed at 16-byte offsets
    mine, layout, off = [], [], 0
    for path, dtype, shape, at, nbytes in entries:
        axis = split.get(path)
        if axis is None:
            t = _wire_typed(dtype, slabs[me][at:at + nbytes]).reshape(shape)
        else:
            t = torch.cat([_wire_typed(dtype, p[at:at + nbytes]).reshape(shape)
                           for p in slabs], axis)
        ax = rank_axis(path, draft_whole)
        if ax is not None and ranks > 1:
            ax %= t.dim()
            width = t.shape[ax] // ranks
            t = t.narrow(ax, me * width, width)
        t = t.contiguous()
        size = t.numel() * t.element_size()
        layout.append((path, dtype, tuple(t.shape), off, size))
        mine.append((off, t.reshape(-1).view(torch.uint8)))
        off += -(-size // 16) * 16
    packed = torch.zeros(off, dtype=torch.uint8, device=comm)
    for at, raw in mine:
        packed[at:at + raw.numel()] = raw
    dev = packed.to(device or "cpu")
    pairs = [(path, _from_wire(path, dtype, dev[at:at + size], shape))
             for path, dtype, shape, at, size in layout]
    h = Handle(requests=reqs, state=_unflatten_state(pairs), p_pad=p_pad)
    dt = time.perf_counter() - t0
    if counters is not None:
        counters.de_s += dt
    _trace.get_tracer().add("handoff.deserialize_sharded", t0, dt,
                            uids=[r.uid for r in reqs])
    return h
