"""Transport counters for the multi-process serving runtime.

Every process in the serving topology (router, prefill workers, decode
replicas — docs/SERVING.md §7) keeps one :class:`TransportCounters` per
socket direction pair and ships a snapshot home in its final ``stats``
message, so bench records can report frames/bytes/serialization seconds
per stage without a second instrumentation layer.

Copied from progen_tpu/observe/transport.py (standard library only); the
port keeps its own copy because it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TransportCounters:
    """Host-side tallies of the handle/message transport.

    ``ser_s``/``de_s`` are wall seconds spent inside
    ``serialize_handle``/``deserialize_handle`` (device_get / device_put
    included — the transport thread is ALLOWED to sync; the admission
    path is not).  ``crc_failures`` counts frames whose payload checksum
    failed but whose header survived (targeted replay); ``desyncs``
    counts unrecoverable stream errors (bad magic, mid-frame EOF) that
    poison the connection.
    """

    frames_out: int = 0
    frames_in: int = 0
    bytes_out: int = 0
    bytes_in: int = 0
    ser_s: float = 0.0
    de_s: float = 0.0
    crc_failures: int = 0
    desyncs: int = 0

    def sent(self, nbytes: int) -> None:
        self.frames_out += 1
        self.bytes_out += nbytes

    def received(self, nbytes: int) -> None:
        self.frames_in += 1
        self.bytes_in += nbytes

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def merge(self, other: "TransportCounters | dict") -> None:
        """Fold another process's snapshot into this one (aggregation in
        the router when building the bench record)."""
        d = other.as_dict() if isinstance(other, TransportCounters) else other
        self.frames_out += int(d.get("frames_out", 0))
        self.frames_in += int(d.get("frames_in", 0))
        self.bytes_out += int(d.get("bytes_out", 0))
        self.bytes_in += int(d.get("bytes_in", 0))
        self.ser_s += float(d.get("ser_s", 0.0))
        self.de_s += float(d.get("de_s", 0.0))
        self.crc_failures += int(d.get("crc_failures", 0))
        self.desyncs += int(d.get("desyncs", 0))
