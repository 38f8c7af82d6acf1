"""The port's data path against the JAX package's: the pure-Python tfrecord
writer gives the JAX writer's bytes; the reader gives the JAX
``iterator_from_tfrecords_folder``'s batches byte for byte on
``train_data_synth/`` (skipped, looped across the corpus wrap, batch 1 and
8, two and three processes at every index), reads shards written by
``tf.io.TFRecordWriter`` and raises on a corrupt byte; the shuffle keeps
the JAX package's contract (``tests/test_data.py``); ``DevicePrefetcher``
keeps ``tests/test_prefetch.py``'s; ``generate_data`` writes the JAX
``generate_tfrecords``' shards byte for byte; and the retry copy behaves
as the original."""

import gzip
import itertools
import struct
import subprocess
import sys
import time
from pathlib import Path

import google_crc32c
import numpy as np
import pytest
import torch

from progen_tpu.data.fasta import generate_tfrecords as jax_generate_tfrecords
from progen_tpu.data.tfrecord import iterator_from_tfrecords_folder as jax_iterator
from progen_tpu.data.tfrecord import write_tfrecord as jax_write_tfrecord
from progen_tpu.resilience import retry as jax_retry
from progen_tpu_torch.data.fasta import generate_tfrecords
from progen_tpu_torch.data.prefetch import DevicePrefetcher
from progen_tpu_torch.data.tfrecord import (
    DataLossError,
    count_sequences,
    crc32c,
    encode_example,
    iterator_from_tfrecords_folder,
    masked_crc32c,
    shard_filename,
    write_tfrecord,
)
from progen_tpu_torch.data import tfrecord
from progen_tpu_torch.data.tokenizer import decode_tokens
from progen_tpu_torch.resilience import faults
from progen_tpu_torch.resilience import retry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SYNTH = str(ROOT / "train_data_synth")
SEQ_LEN = 64


def _payloads(n, seed=0):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(65, 91, rng.integers(1, 300), dtype=np.uint8)) for _ in range(n)]


# -- CRC and the writer -------------------------------------------------------


def test_crc32c_matches_google_crc32c():
    rng = np.random.default_rng(1)
    for n in [0, 1, 7, 8, 9, 15, 16, 100, 1023]:
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert crc32c(data) == google_crc32c.value(data), n
    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_writer_bytes_equal_the_jax_writers(tmp_path):
    payloads = _payloads(200) + [b"", b"x" * 5000]
    name = shard_filename(0, len(payloads), "train")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert write_tfrecord(tmp_path / "port" / name, payloads) == len(payloads)
    jax_write_tfrecord(tmp_path / "jax" / name, payloads)
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


# -- the reader against the JAX iterator ---------------------------------------


@pytest.fixture(scope="module")
def readers():
    return iterator_from_tfrecords_folder(SYNTH, "train"), jax_iterator(SYNTH, "train")


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [
    dict(batch_size=8),
    dict(batch_size=8, skip=37),
    dict(batch_size=1, skip=3),
    dict(batch_size=8, process_count=2, process_index=0, skip=37),
    dict(batch_size=8, process_count=2, process_index=1, skip=37),
    dict(batch_size=8, process_count=3, process_index=0, skip=37),
    dict(batch_size=8, process_count=3, process_index=1, skip=37),
    dict(batch_size=8, process_count=3, process_index=2, skip=37),
], ids=["b8", "skip37", "b1_skip3", "p2_i0", "p2_i1", "p3_i0", "p3_i1", "p3_i2"])
def test_batches_equal_the_jax_iterator(readers, kw):
    (num, port), (jax_num, ref) = readers
    assert num == jax_num == 1900
    _assert_same_batches(list(port(seq_len=SEQ_LEN, **kw)),
                         list(ref(seq_len=SEQ_LEN, **kw)))


@pytest.mark.parametrize("kw", [
    dict(batch_size=8, skip=1890),
    dict(batch_size=8, skip=37, process_count=3, process_index=1),
    dict(batch_size=8, skip=4000),
], ids=["wrap", "wrap_p3", "skip_past_two_passes"])
def test_loop_across_the_corpus_wrap_equals_the_jax_iterator(readers, kw):
    """``loop`` repeats the record stream before skip and batch: batches
    straddle the wrap, all full."""
    (_, port), (_, ref) = readers
    n = 700 // kw.get("process_count", 1) + 4
    got = list(itertools.islice(port(seq_len=SEQ_LEN, loop=True, **kw), n))
    want = list(itertools.islice(ref(seq_len=SEQ_LEN, loop=True, **kw), n))
    assert all(b.shape == (8, SEQ_LEN + 1) for b in got)
    _assert_same_batches(got, want)


def test_reads_a_shard_written_by_tensorflow(tmp_path):
    """``tf.io.TFRecordWriter`` framing and TensorFlow's own Example
    serialisation, with a second feature and a second map entry the
    reader must skip by field number."""
    import tensorflow as tf

    payloads = _payloads(30, seed=2)
    path = tmp_path / shard_filename(0, len(payloads), "train")
    with tf.io.TFRecordWriter(str(path), options=tf.io.TFRecordOptions(
            compression_type="GZIP")) as w:
        for i, p in enumerate(payloads):
            ex = tf.train.Example(features=tf.train.Features(feature={
                "id": tf.train.Feature(int64_list=tf.train.Int64List(value=[i, 7])),
                "seq": tf.train.Feature(bytes_list=tf.train.BytesList(value=[p])),
                "zz": tf.train.Feature(float_list=tf.train.FloatList(value=[0.5]))}))
            w.write(ex.SerializeToString())
    num, it_fn = iterator_from_tfrecords_folder(str(tmp_path), "train")
    assert num == 30 and count_sequences(str(tmp_path), "train") == 30
    rows = np.concatenate(list(it_fn(seq_len=400, batch_size=7)))
    assert [decode_tokens(r) for r in rows] == [p.decode() for p in payloads]


def _framed(records):
    out = b""
    for data in records:
        length = struct.pack("<Q", len(data))
        out += (length + struct.pack("<I", masked_crc32c(length)) + data
                + struct.pack("<I", masked_crc32c(data)))
    return out


@pytest.mark.parametrize("where", ["data", "length", "data_crc", "truncated"])
def test_a_corrupt_record_raises(tmp_path, monkeypatch, where):
    monkeypatch.setenv("PROGEN_DATA_RETRY_ATTEMPTS", "1")
    raw = bytearray(_framed([encode_example(b"MKV" * 20), encode_example(b"MALW")]))
    offset = {"data": 12 + 10, "length": 2, "data_crc": 12 + len(encode_example(b"MKV" * 20))}
    if where == "truncated":
        raw = raw[:-3]
    else:
        raw[offset[where]] ^= 0x01
    path = tmp_path / shard_filename(0, 2, "train")
    path.write_bytes(gzip.compress(bytes(raw)))
    _, it_fn = iterator_from_tfrecords_folder(str(tmp_path), "train")
    with pytest.raises(DataLossError):
        list(it_fn(seq_len=16, batch_size=2))


@pytest.mark.parametrize("kw,headers", [
    (dict(skip=37), 37 + 8),
    # own records are 1, 4, 7, ...: 12 skipped, the batch's last is record 58
    (dict(skip=37, process_count=3, process_index=1), 59),
], ids=["skip37", "p3_i1"])
def test_a_skip_checks_no_data_it_does_not_use(readers, monkeypatch, kw, headers):
    """Records skipped on resume, or another process's, are passed over by
    their checked length: only the batch's own records have their data's
    CRC computed."""
    sizes = []
    real = tfrecord.masked_crc32c
    monkeypatch.setattr(tfrecord, "masked_crc32c",
                        lambda data: sizes.append(len(data)) or real(data))
    (_, port), _ = readers
    next(port(seq_len=SEQ_LEN, batch_size=8, **kw))
    assert sum(n == 8 for n in sizes) == headers
    assert len(sizes) - headers == 8  # the batch's data alone


@pytest.mark.parametrize("where,raises", [("length", True), ("truncated", True),
                                          ("data", False)])
def test_a_skipped_records_length_is_checked_and_its_data_is_not(
        tmp_path, monkeypatch, where, raises):
    monkeypatch.setenv("PROGEN_DATA_RETRY_ATTEMPTS", "1")
    first, second = encode_example(b"MKV" * 20), encode_example(b"MALW")
    raw = bytearray(_framed([first, second]))
    if where == "truncated":
        raw = raw[:-3]
    else:
        raw[{"length": 2, "data": 12 + 10}[where]] ^= 0x01
    path = tmp_path / shard_filename(0, 2, "train")
    path.write_bytes(gzip.compress(bytes(raw)))
    _, it_fn = iterator_from_tfrecords_folder(str(tmp_path), "train")
    skip = 2 if where == "truncated" else 1
    if raises:
        with pytest.raises(DataLossError):
            list(it_fn(seq_len=16, batch_size=1, skip=skip))
    else:
        (batch,) = list(it_fn(seq_len=16, batch_size=1, skip=skip))
        assert decode_tokens(batch[0]) == "MALW"


def test_a_flipped_byte_of_the_gzip_stream_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PROGEN_DATA_RETRY_ATTEMPTS", "1")
    path = tmp_path / shard_filename(0, 50, "train")
    write_tfrecord(path, _payloads(50, seed=3))
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x10
    path.write_bytes(bytes(raw))
    _, it_fn = iterator_from_tfrecords_folder(str(tmp_path), "train")
    with pytest.raises(Exception):
        list(it_fn(seq_len=16, batch_size=4))


def test_gcs_paths_are_refused(tmp_path):
    with pytest.raises(ValueError, match="not ported"):
        iterator_from_tfrecords_folder("gs://bucket/data", "train")
    with pytest.raises(ValueError, match="not ported"):
        write_tfrecord("gs://bucket/0.1.train.tfrecord.gz", [b"A"])


def test_open_is_retried_under_the_data_open_fault(tmp_path, monkeypatch):
    monkeypatch.setenv("PROGEN_DATA_RETRY_BASE_DELAY", "0.01")
    write_tfrecord(tmp_path / shard_filename(0, 3, "train"), [b"A", b"B", b"C"])
    _, it_fn = iterator_from_tfrecords_folder(str(tmp_path), "train")
    faults.configure("data.open:io_error:times=2")
    try:
        rows = np.concatenate(list(it_fn(seq_len=4, batch_size=2)))
    finally:
        faults.reset()
    assert [decode_tokens(r) for r in rows] == ["A", "B", "C"]


# -- the shuffle's contract (tests/test_data.py, on the port) -------------------


@pytest.fixture()
def small_dir(tmp_path):
    seqs = [f"SEQ{i:03d}PROTEIN".encode() for i in range(20)]
    write_tfrecord(tmp_path / shard_filename(0, 12, "train"), seqs[:12])
    write_tfrecord(tmp_path / shard_filename(1, 8, "train"), seqs[12:])
    return tmp_path


def test_shuffle_buffer_permutes_but_preserves_records(small_dir):
    _, it_fn = iterator_from_tfrecords_folder(str(small_dir), "train")
    plain = np.concatenate(list(it_fn(seq_len=16, batch_size=4)))
    shuffled = np.concatenate(list(it_fn(seq_len=16, batch_size=4, shuffle_buffer=8, seed=1)))
    assert sorted(decode_tokens(r) for r in shuffled) == sorted(
        decode_tokens(r) for r in plain)
    assert not np.array_equal(shuffled, plain)
    again = np.concatenate(list(it_fn(seq_len=16, batch_size=4, shuffle_buffer=8, seed=1)))
    np.testing.assert_array_equal(shuffled, again)
    other = np.concatenate(list(it_fn(seq_len=16, batch_size=4, shuffle_buffer=8, seed=2)))
    assert not np.array_equal(shuffled, other)


@pytest.mark.parametrize("skip", [8, 5])
def test_shuffled_resume_is_deterministic(small_dir, skip):
    _, it_fn = iterator_from_tfrecords_folder(str(small_dir), "train")
    kw = dict(seq_len=16, batch_size=4, shuffle_buffer=8, seed=5)
    full = np.concatenate(list(it_fn(**kw)))
    resumed = np.concatenate(list(it_fn(skip=skip, **kw)))
    np.testing.assert_array_equal(resumed, full[skip:])


def test_shuffled_resume_multihost_matches_uninterrupted(small_dir):
    _, it_fn = iterator_from_tfrecords_folder(str(small_dir), "train")
    for idx in range(2):
        kw = dict(seq_len=16, batch_size=2, process_count=2, process_index=idx,
                  shuffle_buffer=4, seed=3)
        full = np.concatenate(list(it_fn(**kw)))
        resumed = np.concatenate(list(it_fn(skip=8, **kw)))
        np.testing.assert_array_equal(resumed, full[4:])


def test_shuffled_loop_resume_continues_stream(small_dir):
    _, it_fn = iterator_from_tfrecords_folder(str(small_dir), "train")
    kw = dict(seq_len=16, batch_size=4, loop=True, shuffle_buffer=8, seed=7)
    it = it_fn(**kw)
    full = np.concatenate([next(it) for _ in range(10)])
    it2 = it_fn(skip=12, **kw)
    resumed = np.concatenate([next(it2) for _ in range(7)])
    np.testing.assert_array_equal(resumed, full[12:])


def test_loop_skip_records_reappear_on_wrap(small_dir):
    _, it_fn = iterator_from_tfrecords_folder(str(small_dir), "train")
    ordered = np.concatenate(list(it_fn(seq_len=16, batch_size=4)))
    it = it_fn(seq_len=16, batch_size=4, loop=True, skip=6)
    got = np.concatenate([next(it) for _ in range(5)])
    np.testing.assert_array_equal(got[:14], ordered[6:])
    np.testing.assert_array_equal(got[14:20], ordered[:6])


# -- DevicePrefetcher (tests/test_prefetch.py, on the port) --------------------


def test_prefetch_preserves_order_and_transform():
    batches = [np.full((2, 3), i) for i in range(10)]
    out = list(DevicePrefetcher(iter(batches), lambda b: b + 1, depth=2))
    assert len(out) == 10
    for i, b in enumerate(out):
        np.testing.assert_array_equal(b, batches[i] + 1)


def test_prefetch_stopiteration_propagates():
    pf = DevicePrefetcher(iter([1, 2]), lambda x: x, depth=2)
    assert next(pf) == 1 and next(pf) == 2
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetch_iterator_error_raised_on_consumer_thread():
    def gen():
        yield 1
        raise RuntimeError("boom")

    pf = DevicePrefetcher(gen(), lambda x: x, depth=2)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)


def test_prefetch_close_unblocks_worker_on_full_queue():
    pf = DevicePrefetcher(itertools.count(), lambda x: x, depth=1)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetch_buffers_ahead():
    produced = []

    def gen():
        for i in range(4):
            produced.append(i)
            yield i

    pf = DevicePrefetcher(gen(), lambda x: x, depth=2)
    deadline = time.monotonic() + 5.0
    while len(produced) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 2
    assert list(pf) == [0, 1, 2, 3]


def test_prefetch_to_a_cpu_device_gives_tensors():
    batches = [np.full((2, 3), i, np.int32) for i in range(3)]
    out = list(DevicePrefetcher(iter(batches), device="cpu"))
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.int32 for t in out)
    assert [int(t[0, 0]) for t in out] == [0, 1, 2]
    with pytest.raises(ValueError, match="exactly one"):
        DevicePrefetcher(iter(batches))


# -- generate_data --------------------------------------------------------------


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("fasta") / "synthetic.fasta"
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_synthetic_fasta.py"),
                    str(path), "120", "4"], check=True, capture_output=True, timeout=120)
    return path


def _tree_bytes(folder: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(folder.iterdir())}


def test_generate_tfrecords_equals_the_jax_shards(fasta, tmp_path):
    kw = dict(max_seq_len=600, num_samples=100, fraction_valid_data=0.1,
              num_sequences_per_file=40, annotations=("tax", "go"), seed=3,
              num_workers=0)
    got = generate_tfrecords(str(fasta), str(tmp_path / "port"), **kw)
    want = jax_generate_tfrecords(str(fasta), str(tmp_path / "jax"), **kw)
    assert got == want and got["train"] > 100  # tax strings double the records
    port, ref = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert list(port) == list(ref) and port == ref


def test_generate_data_cli_writes_the_jax_shards(fasta, tmp_path):
    (tmp_path / "cfg").mkdir()
    (tmp_path / "cfg" / "synth.toml").write_text(
        f'read_from = "{fasta}"\nwrite_to = "{tmp_path / "out"}"\n'
        "num_samples = 60\nfraction_valid_data = 0.05\nnum_sequences_per_file = 50\n")
    run = subprocess.run(
        [sys.executable, "-m", "progen_tpu_torch.generate_data", "--data_dir",
         str(tmp_path / "cfg"), "--name", "synth", "--seed", "1", "--num_workers", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    assert "valid sequences" in run.stdout
    jax_generate_tfrecords(str(fasta), str(tmp_path / "jax"), num_samples=60,
                           fraction_valid_data=0.05, num_sequences_per_file=50,
                           seed=1, num_workers=0)
    assert _tree_bytes(tmp_path / "out") == _tree_bytes(tmp_path / "jax")


# -- the retry copy, pinned to the original ----------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(seed=7, max_attempts=6, base_delay=0.1),
                                dict(jitter=0.0, max_delay=1.0, multiplier=3.0)])
def test_retry_delays_equal_the_originals(kw):
    assert list(retry.RetryPolicy(**kw).delays()) == list(jax_retry.RetryPolicy(**kw).delays())


def test_retry_policy_from_env_equals_the_originals(monkeypatch):
    monkeypatch.setenv("PROGEN_X_ATTEMPTS", "7")
    monkeypatch.setenv("PROGEN_X_BASE_DELAY", "0.25")
    monkeypatch.setenv("PROGEN_X_ATTEMPT_TIMEOUT", "3")
    got = retry.RetryPolicy.from_env("PROGEN_X", deadline=9.0)
    want = jax_retry.RetryPolicy.from_env("PROGEN_X", deadline=9.0)
    fields = ("max_attempts", "base_delay", "multiplier", "max_delay", "jitter",
              "deadline", "attempt_timeout", "seed")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert got.max_attempts == 7 and got.attempt_timeout == 3.0 and got.deadline == 9.0


def test_retry_attempt_timeout_abandons_a_hung_attempt():
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(5)
        return "ok"

    policy = retry.RetryPolicy(max_attempts=2, base_delay=0.01, attempt_timeout=0.2)
    t0 = time.monotonic()
    assert retry.retry_call(fn, policy=policy, on_retry=lambda *a: None) == "ok"
    assert time.monotonic() - t0 < 3 and len(calls) == 2
    with pytest.raises(retry.RetryError) as e:
        retry.retry_call(lambda: time.sleep(5), on_retry=lambda *a: None,
                         policy=retry.RetryPolicy(max_attempts=1, attempt_timeout=0.1))
    assert isinstance(e.value.__cause__, retry.AttemptTimeout)


def test_retriable_retries_transient_and_not_fatal():
    calls = []

    @retry.retriable(retry.RetryPolicy(max_attempts=3, base_delay=0.001))
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionResetError("reset")
        return len(calls)

    assert flaky() == 3

    @retry.retriable(retry.RetryPolicy(max_attempts=3, base_delay=0.001))
    def fatal():
        calls.append(1)
        raise ValueError("config")

    calls.clear()
    with pytest.raises(ValueError):
        fatal()
    assert calls == [1]
