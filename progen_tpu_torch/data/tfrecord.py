"""TFRecord protein-sequence pipeline in pure Python: reader and writer.

Ported from progen_tpu/data/tfrecord.py without TensorFlow or
``google_crc32c``.  Format contract (the JAX package's):

* records are GZIP TFRecords with ONE bytes feature ``'seq'`` holding the
  raw UTF-8 sequence string;
* filename protocol ``{file_index}.{num_sequences}.{train|valid}.tfrecord.gz``;
  the reader derives corpus size by summing the ``num_sequences`` field;
* collation: bytes -> ints, truncate to ``seq_len``, +1 tokenizer offset
  applied AT COLLATE TIME, right-pad with 0, prepend a zero BOS column ->
  ``(B, seq_len + 1)`` int32;
* resume-by-skip: ``skip`` consumed records before batching;
* ``process_count``/``process_index`` shard the RECORD stream across
  processes round robin: process h skips ``ceil((skip - h) / P)`` of its
  own records for a global cursor ``skip``.

The framing is parsed here: each record is an 8-byte little-endian length,
the masked CRC32C of those 8 bytes, the data, and the masked CRC32C of the
data.  A CRC that does not match raises :class:`DataLossError`; the data
of a record that is skipped, or is another process's, is passed over
unread and unchecked, since it is never used.  The
``Example`` proto is parsed by field number, so shards written by
``tf.io.TFRecordWriter`` read the same as the hand-encoded ones written
here.  Unshuffled, sharded and skipped streams give the JAX iterator's
batches byte for byte; the shuffle keeps its contract, not its order (see
:func:`sliding_shuffle`).
"""

from __future__ import annotations

import gzip
import itertools
import struct
from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np

from progen_tpu_torch.data.tokenizer import OFFSET
from progen_tpu_torch.resilience import faults
from progen_tpu_torch.resilience.retry import RetryPolicy, retry_call

_MASK32 = 0xFFFFFFFF
_CRC32C_POLY = 0x82F63B78  # Castagnoli, bit-reflected


class DataLossError(ValueError):
    """A record's framing or checksum is wrong: the shard is corrupt."""


def _retry_policy() -> RetryPolicy:
    """Stream-open retry, env-tunable through ``PROGEN_DATA_RETRY_*``."""
    return RetryPolicy.from_env("PROGEN_DATA_RETRY", base_delay=0.5,
                                deadline=60.0)


def _refuse_gcs(path) -> None:
    if str(path).startswith("gs://"):
        raise ValueError(f"{path}: gs:// paths are not ported (the port has "
                         "no GCS client); copy the shards to a local folder")


# ---------------------------------------------------------------------------
# CRC32C


def _crc32c_tables() -> list[list[int]]:
    """The slicing-by-8 tables: ``t[0]`` is the byte table, ``t[k][i]`` the
    CRC of byte ``i`` followed by ``k`` zero bytes."""
    first = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        first.append(c)
    tables = [first]
    for _ in range(7):
        prev = tables[-1]
        tables.append([(prev[i] >> 8) ^ first[prev[i] & 0xFF] for i in range(256)])
    return tables


_T0, _T1, _T2, _T3, _T4, _T5, _T6, _T7 = _crc32c_tables()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``, eight bytes a step."""
    crc = _MASK32
    n8 = len(data) & ~7
    for one, two in struct.iter_unpack("<II", memoryview(data)[:n8]):
        one ^= crc
        crc = (_T7[one & 0xFF] ^ _T6[(one >> 8) & 0xFF] ^ _T5[(one >> 16) & 0xFF]
               ^ _T4[one >> 24] ^ _T3[two & 0xFF] ^ _T2[(two >> 8) & 0xFF]
               ^ _T1[(two >> 16) & 0xFF] ^ _T0[two >> 24])
    for b in data[n8:]:
        crc = _T0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ _MASK32


def masked_crc32c(data: bytes) -> int:
    """TFRecord framing checksum: crc32c rotated right 15 and offset."""
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & _MASK32


# ---------------------------------------------------------------------------
# writing


def shard_filename(file_index: int, num_sequences: int, data_type: str) -> str:
    """The reference's filename protocol."""
    return f"{file_index}.{num_sequences}.{data_type}.tfrecord.gz"


def parse_shard_filename(name: str) -> int:
    """Number of sequences encoded in a shard filename."""
    return int(name.split(".")[-4])


def _varint(n: int) -> bytes:
    """Protobuf base-128 varint."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_example(payload: bytes) -> bytes:
    """Hand-encoded ``tf.train.Example`` proto wire bytes for
    ``features { feature { key: "seq" value { bytes_list { value: [payload]
    } } } }``.  Every level is field 1 (length-delimited, tag ``0x0a``)
    except the map entry's value, field 2 (tag ``0x12``)."""
    bytes_list = b"\x0a" + _varint(len(payload)) + payload
    feature = b"\x0a" + _varint(len(bytes_list)) + bytes_list
    entry = b"\x0a\x03seq" + b"\x12" + _varint(len(feature)) + feature
    features = b"\x0a" + _varint(len(entry)) + entry
    return b"\x0a" + _varint(len(features)) + features


def write_tfrecord(path: str, payloads: Iterable[bytes]) -> int:
    """Write raw byte payloads as GZIP TFRecords with the 'seq' feature;
    returns the number of records written.

    The bytes equal the JAX package's local writer's: the gzip header is
    written with ``mtime=0`` (no timestamp, so identical payloads give
    identical shards) and ``compresslevel=6``, zlib's default and
    ``TFRecordOptions("GZIP")``'s."""
    _refuse_gcs(path)
    n = 0
    with open(str(path), "wb") as raw, gzip.GzipFile(
        fileobj=raw, mode="wb", compresslevel=6, mtime=0
    ) as f:
        for payload in payloads:
            data = encode_example(payload)
            length = struct.pack("<Q", len(data))
            f.write(length)
            f.write(struct.pack("<I", masked_crc32c(length)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc32c(data)))
            n += 1
    return n


# ---------------------------------------------------------------------------
# reading


def read_records(path: str, wanted: Callable[[], bool] | None = None
                 ) -> Iterator[bytes | None]:
    """The serialized records of one GZIP TFRecord file, each checked
    against both of its CRCs.

    ``wanted``, if given, is called once a record, in order, after its
    length is read and checked: a record it declines yields None, and its
    data is passed over without being read or checked, since it is never
    used (a resume's skip, another process's share)."""
    with gzip.open(str(path), "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise DataLossError(f"{path}: truncated record header")
            (length,), (want,) = struct.unpack("<Q", head[:8]), struct.unpack("<I", head[8:])
            if masked_crc32c(head[:8]) != want:
                raise DataLossError(f"{path}: corrupted record length (CRC mismatch)")
            if wanted is not None and not wanted():
                if len(f.read(length + 4)) < length + 4:
                    raise DataLossError(f"{path}: truncated record")
                yield None
                continue
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise DataLossError(f"{path}: truncated record")
            if masked_crc32c(data) != struct.unpack("<I", footer)[0]:
                raise DataLossError(f"{path}: corrupted record data (CRC mismatch)")
            yield data


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise DataLossError("truncated varint in an Example proto")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _proto_fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """``(field number, wire type, value)`` of each field of a message:
    bytes for length-delimited fields, ints otherwise."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + size], pos + size
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise DataLossError(f"unsupported proto wire type {wire}")
        if pos > len(buf):
            raise DataLossError("truncated field in an Example proto")
        yield field, wire, value


def parse_example_bytes(record: bytes, key: bytes = b"seq") -> bytes:
    """The one value of the bytes feature ``key`` of a serialized
    ``tf.train.Example`` (``FixedLenFeature([], tf.string)``), read by field
    number: Example.features = 1, Features.feature = 1 (map entries: key 1,
    value 2), Feature.bytes_list = 1, BytesList.value = 1.  A later entry
    for the same key wins, as protobuf merges maps."""
    found = None
    for field, wire, features in _proto_fields(record):
        if field != 1 or wire != 2:
            continue
        for f2, w2, entry in _proto_fields(features):
            if f2 != 1 or w2 != 2:
                continue
            name = value = None
            for f3, w3, v3 in _proto_fields(entry):
                if f3 == 1 and w3 == 2:
                    name = bytes(v3)
                elif f3 == 2 and w3 == 2:
                    value = v3
            if name == key:
                found = value if value is not None else b""
    if found is None:
        raise DataLossError(f"Example has no {key.decode()!r} feature")
    values = []
    for f4, w4, bytes_list in _proto_fields(found):
        if f4 == 1 and w4 == 2:
            values.extend(bytes(v) for f5, w5, v in _proto_fields(bytes_list)
                          if f5 == 1 and w5 == 2)
    if len(values) != 1:
        raise DataLossError(
            f"feature {key.decode()!r} holds {len(values)} values, want 1")
    return values[0]


def list_shards(folder: str, data_type: str = "train") -> list[str]:
    """Shard files for a split, sorted (glob order is unstable)."""
    _refuse_gcs(folder)

    def _glob() -> list[str]:
        faults.inject("data.glob")
        return [str(p) for p in Path(folder).glob(f"**/*.{data_type}.tfrecord.gz")]

    return sorted(retry_call(_glob, policy=_retry_policy(), label="data.glob"))


def count_sequences(folder: str, data_type: str = "train") -> int:
    return sum(parse_shard_filename(n) for n in list_shards(folder, data_type))


def collate(raw_seqs: list[bytes], seq_len: int, offset: int = OFFSET) -> np.ndarray:
    """Raw byte strings -> ``(B, seq_len + 1)`` int32 with BOS column."""
    batch = np.zeros((len(raw_seqs), seq_len + 1), dtype=np.int32)
    for i, raw in enumerate(raw_seqs):
        toks = np.frombuffer(raw, dtype=np.uint8)[:seq_len].astype(np.int32) + offset
        batch[i, 1 : 1 + len(toks)] = toks
    return batch


def sliding_shuffle(stream: Iterable, buffer_size: int, seed: int) -> Iterator:
    """A seeded sliding-buffer shuffle: fill a buffer with the first
    ``buffer_size`` items; then each output is the slot at an index drawn
    from ``numpy.random.Generator(PCG64(seed))``, and the stream's next item
    refills that slot; when the stream ends the buffer drains (the last
    slot moves into the emptied one).

    It is a pure function of the seed and the input stream, so a resumed
    reader that replays the stream and skips the outputs already consumed
    continues the interrupted order exactly: the contract the JAX
    package's ``tf.data`` shuffle is held to.  Its order is not
    ``tf.data``'s: that comes from TensorFlow's compiled Philox stream,
    which is not code of this repo, and TensorFlow is not a dependency of
    the port."""
    rng = np.random.Generator(np.random.PCG64(seed))
    it = iter(stream)
    buf = list(itertools.islice(it, buffer_size))
    end = object()
    while buf:
        i = int(rng.integers(len(buf)))
        out = buf[i]
        nxt = next(it, end)
        if nxt is end:
            buf[i] = buf[-1]
            buf.pop()
        else:
            buf[i] = nxt
        yield out


def _record_stream(filenames: list[str], loop: bool, process_count: int,
                   process_index: int, skip: int = 0) -> Iterator[bytes]:
    """Serialized records of every shard in order, this process's round-robin
    share of them, repeated forever under ``loop`` (sharded, then repeated,
    as ``ds.shard(...).repeat()``), less the first ``skip`` records of that
    share.  Records outside the share or skipped are passed over unread."""
    owned = 0  # records of this process's share met so far, over all passes
    while True:
        index = itertools.count()  # a record's place in this pass
        seen = False

        def wanted() -> bool:
            nonlocal owned, seen
            if next(index) % process_count != process_index:
                return False
            seen = True
            owned += 1
            return owned > skip

        for record in itertools.chain.from_iterable(
                read_records(f, wanted) for f in filenames):
            if record is not None:
                yield record
        if not (loop and seen):
            return


def _batches(stream: Iterator, batch_size: int, drop_remainder: bool) -> Iterator[list]:
    while True:
        batch = list(itertools.islice(stream, batch_size))
        if not batch or (drop_remainder and len(batch) < batch_size):
            return
        yield batch


def iterator_from_tfrecords_folder(folder: str, data_type: str = "train"):
    """Returns ``(num_seqs, iter_fn)``, the JAX package's reader factory:
    ``iter_fn(seq_len, batch_size, skip=0, loop=False, process_count=1,
    process_index=0, shuffle_buffer=0, seed=0)`` yields int32 numpy batches
    ``(B, seq_len + 1)``.

    ``loop`` repeats the RECORD stream before skip and batch, so every
    batch is full (``drop_remainder=loop``) and records skipped on resume
    reappear in later passes.  Unshuffled, the skip passes over raw
    records by their length alone; shuffled, it drops the shuffle's
    OUTPUTS (each record read and checked, parsed only if kept), so a
    resume replays the interrupted order.  The open and the first fetch are
    retried as one unit (fault point ``data.open``); a failure mid-stream
    is not, since the stream position would be lost (the trainer's resume
    is the recovery at that level)."""
    filenames = list_shards(folder, data_type)
    num_seqs = sum(parse_shard_filename(n) for n in filenames)

    def iter_fn(
        seq_len: int,
        batch_size: int,
        skip: int = 0,
        loop: bool = False,
        process_count: int = 1,
        process_index: int = 0,
        shuffle_buffer: int = 0,
        seed: int = 0,
    ) -> Iterator[np.ndarray]:
        if process_count > 1:
            per_host_skip = max(0, -(-(skip - process_index) // process_count))
        else:
            per_host_skip = skip

        def _open():
            faults.inject("data.open")
            stream = _record_stream(filenames, loop, process_count, process_index,
                                    skip=0 if shuffle_buffer else per_host_skip)
            if shuffle_buffer:
                stream = itertools.islice(
                    sliding_shuffle(stream, shuffle_buffer, seed), per_host_skip, None)
            batches = _batches(map(parse_example_bytes, stream), batch_size,
                               drop_remainder=loop)
            return batches, next(batches, None)

        batches, first = retry_call(_open, policy=_retry_policy(), label="data.open")
        if first is None:
            return
        yield collate(first, seq_len)
        for raw in batches:
            yield collate(raw, seq_len)

    return num_seqs, iter_fn
