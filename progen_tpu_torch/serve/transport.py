"""Socket transport: length-prefixed frames between serving processes.

One TCP connection per worker, one frame (``decode/handoff.py`` wire
format) per message.  Control messages are frames with an empty
payload; handle frames carry the serialized state arrays.  The router
relays handle frames VERBATIM — it parses only the prefix + JSON header
(:func:`peek_header`, header-CRC checked) and never touches the
payload, so the payload bytes cross the router zero-copy and a payload
CRC failure is detected exactly once, at the consuming replica.

Threading: each :class:`Peer` owns one daemon reader thread that
pushes ``("frame", peer, header, frame)`` / ``("dead", peer, reason)``
events onto a shared queue.  Reader threads are TRANSPORT threads —
they may sync (serialize/deserialize on worker mains) — while the
router/cluster admission path that consumes the events must not
(``analysis/rules_hostsync.py``).

Copied from progen_tpu/serve/transport.py (sockets and the standard
library only); the port keeps its own copy because it imports nothing of
the JAX package.
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
import zlib

from progen_tpu_torch.decode.handoff import (
    FRAME_PREFIX_LEN,
    FrameDesync,
    pack_frame,
    parse_prefix,
)

# a frame larger than this is a desynced stream, not a real handle
MAX_FRAME_BYTES = 1 << 32


def _read_exact(sock: socket.socket, n: int, *, first: bool = False) -> bytes:
    """Read exactly ``n`` bytes.  Empty ``b""`` on clean EOF at a frame
    boundary (``first=True``); :class:`FrameDesync` on EOF mid-frame."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if first and not buf:
                return b""
            raise FrameDesync(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket, counters=None) -> bytes | None:
    """Read one complete frame; None on clean EOF at a boundary.

    The prefix and declared lengths are validated here (bad magic or a
    mid-frame EOF raises :class:`FrameDesync` — the stream is
    poisoned); payload CRC is deliberately NOT checked, so relays stay
    zero-copy and the check happens once at the consumer.
    """
    prefix = _read_exact(sock, FRAME_PREFIX_LEN, first=True)
    if not prefix:
        return None
    hlen, plen, _, _ = parse_prefix(prefix)
    if hlen + plen > MAX_FRAME_BYTES:
        raise FrameDesync(f"implausible frame size {hlen + plen}")
    body = _read_exact(sock, hlen + plen)
    frame = prefix + body
    if counters is not None:
        counters.received(len(frame))
    return frame


def send_frame(sock: socket.socket, frame: bytes, counters=None,
               lock: threading.Lock | None = None) -> None:
    if lock is not None:
        with lock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)
    if counters is not None:
        counters.sent(len(frame))


def peek_header(frame: bytes) -> dict:
    """Parse a frame's JSON header without touching the payload (the
    router's relay path).  Header CRC is verified; payload CRC is not."""
    hlen, _, hcrc, _ = parse_prefix(frame[:FRAME_PREFIX_LEN])
    hdr = frame[FRAME_PREFIX_LEN:FRAME_PREFIX_LEN + hlen]
    if len(hdr) < hlen:
        raise FrameDesync("frame shorter than declared header")
    if zlib.crc32(hdr) != hcrc:
        raise FrameDesync("frame header CRC mismatch")
    try:
        return json.loads(hdr)
    except ValueError as e:
        raise FrameDesync(f"frame header is not JSON: {e}") from e


def connect(port: int, *, host: str = "127.0.0.1", timeout: float = 60.0,
            retry_every: float = 0.2) -> socket.socket:
    """Worker-side connect with retry — the router's listener may come
    up after the worker process does."""
    deadline = time.perf_counter() + timeout
    last: Exception | None = None
    while time.perf_counter() < deadline:
        try:
            sock = socket.create_connection((host, port), timeout=timeout)
        except OSError as e:
            last = e
            time.sleep(retry_every)
            continue
        try:
            # the timeout bounds the CONNECT attempt only: the reader
            # thread blocks in recv() across idle lulls (a prefill
            # worker between requests, a replica mid-decode), and an
            # inherited timeout would surface there as a spurious peer
            # death after the first quiet minute
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock
        except OSError as e:
            sock.close()
            last = e
            time.sleep(retry_every)
    raise ConnectionError(f"could not reach router on port {port}: {last}")


class Peer:
    """One connected serving process, as seen by the router (or the
    router, as seen by a worker).  Identity (``role``/``index``) is
    unknown until the peer's hello frame arrives."""

    def __init__(self, sock: socket.socket, counters=None):
        self.sock = sock
        self.counters = counters
        self.role: str | None = None
        self.index: int | None = None
        self.alive = True
        # set by the cluster when the worker's "ready" frame arrives;
        # staleness is not judged before then (engine build sends no
        # heartbeats and a cold jit compile can take minutes)
        self.ready = False
        self.last_seen = time.perf_counter()
        self._send_lock = threading.Lock()
        self._reader: threading.Thread | None = None

    @property
    def name(self) -> str:
        return f"{self.role or '?'}:{self.index if self.index is not None else '?'}"

    def send_json(self, obj: dict) -> None:
        self.send_bytes(pack_frame(obj))

    def send_bytes(self, frame: bytes) -> None:
        try:
            send_frame(self.sock, frame, self.counters,
                       lock=self._send_lock)
        except OSError:
            # the reader thread reports the death; a failed send is not
            # a separate event (the message is replayed or shed there)
            self.alive = False

    def start_reader(self, events: "queue.Queue") -> None:
        """Spawn the daemon reader: every inbound frame becomes a
        ``("frame", peer, header, frame)`` event; any stream error a
        single ``("dead", peer, reason)`` event."""

        def _run():
            while True:
                try:
                    frame = recv_frame(self.sock, self.counters)
                except (FrameDesync, OSError) as e:
                    if self.counters is not None and \
                            isinstance(e, FrameDesync):
                        self.counters.desyncs += 1
                    self.alive = False
                    events.put(("dead", self, str(e)))
                    return
                if frame is None:
                    self.alive = False
                    events.put(("dead", self, "eof"))
                    return
                self.last_seen = time.perf_counter()
                try:
                    header = peek_header(frame)
                except FrameDesync as e:
                    if self.counters is not None:
                        self.counters.desyncs += 1
                    self.alive = False
                    events.put(("dead", self, str(e)))
                    return
                events.put(("frame", self, header, frame))

        self._reader = threading.Thread(
            target=_run, daemon=True,
            name=f"peer-reader-{self.name}")
        self._reader.start()

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
