"""FASTA -> tfrecords data preparation (copied from progen_tpu/data/fasta.py;
it writes through the port's pure-Python ``write_tfrecord``, and its shards
are byte-identical to the JAX package's for the same FASTA and seed).

Behavioral contract (the reference ProGen repo's ``generate_data.py``):

* stream a (Uniref50-style) FASTA, filter records with sequence length
  ``<= max_seq_len``, take the first ``num_samples`` (``:94-99``);
* per record emit 1-2 training strings (``:45-74``): always ``"# SEQ"``;
  additionally, when a ``Tax=`` annotation parses from the description
  (regex ``Tax=([a-zA-Z\\s]*)\\s[a-zA-Z\\=]``, ``:37``), emit
  ``"[tax=X] # SEQ"`` with the (annotation, sequence) pair order inverted
  with probability ``prob_invert_seq_annotation`` (``:63-64``) — the ``#``
  separator doubles as the sampling-prime convention;
* shuffle, split off ``fraction_valid_data`` for validation, shard into
  files of ``num_sequences_per_file``, write GZIP tfrecords named by the
  shard filename protocol (``:107-153``); local paths only.

Structural changes (SURVEY.md §7.7, all conscious):

* the reference's Prefect 2-task DAG and pyfaidx index are replaced by a
  plain streaming parser + a ``multiprocessing`` pool (the reference README
  itself lists "utilize all cores" as a TODO, ``README.md:109``);
* no ``./.tmp`` staging of one-gzip-file-per-sequence (the reference writes
  N tiny files to disk and reads them back, ``:76-79,145-149``) — strings
  go straight to the shard writer;
* randomness is seeded and reproducible (the reference uses the global
  ``random``/``np.random`` state unseeded).
"""

from __future__ import annotations

import gzip
import math
import re
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from progen_tpu_torch.data.tfrecord import shard_filename, write_tfrecord

TAX_RE = re.compile(r"Tax=([a-zA-Z\s]*)\s[a-zA-Z\=]")
# GO terms as they appear in UniProt/UniRef-derived descriptions: the
# canonical 7-digit accession ``GO:0016021``, one or many (e.g. a custom
# export's ``GO=GO:0016021; GO:0005886`` field).  The reference extracts
# only Tax= (the reference generate_data.py:36-43); GO conditioning is
# the BASELINE.json ProGen-large capability ("+ GO annotation
# conditioning") the same mechanism extends to.
GO_RE = re.compile(r"(?<!\d)GO:(\d{7})(?!\d)")  # digit-bounded: GO:00160215 is NOT a GO term


def _extract_tax(description: str) -> str | None:
    m = TAX_RE.findall(description)
    return m[0] if m else None


def _extract_go(description: str) -> str | None:
    terms = GO_RE.findall(description)
    if not terms:
        return None
    # deduplicate, keep first-seen order: "GO:0016021,GO:0005886"
    seen = dict.fromkeys(terms)
    return ",".join(f"GO:{t}" for t in seen)


# config-driven extractor set: each key becomes a ``[key=value]`` prefix
# token when its extractor finds a value in the FASTA description
EXTRACTORS = {"tax": _extract_tax, "go": _extract_go}


def parse_fasta(path: str) -> Iterator[tuple[str, str]]:
    """Stream ``(description, sequence)`` pairs; transparently handles
    ``.gz``.  Sequences are upper-cased (the reference's
    ``sequence_always_upper=True``)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        desc = None
        chunks: list[str] = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if desc is not None:
                    yield desc, "".join(chunks).upper()
                desc = line[1:]
                chunks = []
            else:
                chunks.append(line)
        if desc is not None:
            yield desc, "".join(chunks).upper()


def annotations_from_description(
    description: str, annotations: tuple[str, ...] = ("tax",)
) -> dict[str, str]:
    """Extract the requested annotation keys from a FASTA description.

    ``annotations`` selects from :data:`EXTRACTORS` (``"tax"``, ``"go"``);
    the default matches the reference's Tax-only behavior
    (the reference ``generate_data.py:36-43``)."""
    out = {}
    for key in annotations:
        value = EXTRACTORS[key](description)
        if value is not None:
            out[key] = value
    return out


def sequence_strings(
    description: str,
    seq: str,
    rng: np.random.Generator,
    prob_invert: float = 0.5,
    sort_annotations: bool = True,
    annotation_keys: tuple[str, ...] = ("tax",),
) -> list[bytes]:
    """1-2 encoded training strings per FASTA record (reference ``:45-74``).

    With multiple annotation keys the prefix is multi-token, e.g.
    ``"[go=GO:0016021] [tax=Escherichia coli] # SEQ"`` — same sort/invert
    semantics as the reference's single-key case (sorted keys unless
    ``sort_annotations=False`` shuffles them; the whole annotation block
    swaps sides with the sequence with probability ``prob_invert``)."""
    out: list[bytes] = []
    annotations = annotations_from_description(description, annotation_keys)
    if annotations:
        keys = sorted(annotations) if sort_annotations else list(annotations)
        if not sort_annotations:
            rng.shuffle(keys)
        annot_str = " ".join(f"[{k}={annotations[k]}]" for k in keys)
        pair = (annot_str, seq)
        if rng.random() <= prob_invert:
            pair = tuple(reversed(pair))
        out.append(" # ".join(pair).encode("utf-8"))
    out.append(f"# {seq}".encode("utf-8"))
    return out


def _format_record(args: tuple) -> list[bytes]:
    """Pool worker: format one FASTA record into its 1-2 training strings.

    The rng is derived from ``(seed, record_index)`` so the output is
    deterministic and IDENTICAL regardless of worker count or scheduling
    (the serial path uses the same derivation).
    """
    idx, desc, seq, prob_invert, sort_annotations, annotation_keys, seed = args
    rng = np.random.default_rng([seed, idx])
    return sequence_strings(desc, seq, rng, prob_invert, sort_annotations,
                            annotation_keys)


def _filtered_records(
    read_from: str, max_seq_len: int, num_samples: int | None
) -> Iterator[tuple[int, str, str]]:
    taken = 0
    for desc, seq in parse_fasta(read_from):
        # empty sequences would collate to an all-zero row, which the eval
        # step's real-row mask (train/step.py) treats as batch padding and
        # silently drops — exclude them here so that heuristic stays sound
        # (every emitted string then contains at least "# " + content)
        if not seq or len(seq) > max_seq_len:
            continue
        yield taken, desc, seq
        taken += 1
        if num_samples is not None and taken >= num_samples:
            return


def generate_tfrecords(
    read_from: str,
    write_to: str,
    *,
    max_seq_len: int = 1024,
    num_samples: int | None = None,
    fraction_valid_data: float = 0.025,
    num_sequences_per_file: int = 1000,
    prob_invert_seq_annotation: float = 0.5,
    sort_annotations: bool = True,
    annotations: tuple[str, ...] = ("tax",),
    seed: int = 0,
    num_workers: int | None = None,
) -> dict[str, int]:
    """Run the full prep: returns ``{"train": n, "valid": m}`` counts.

    ``annotations``: which :data:`EXTRACTORS` keys to mine from each FASTA
    description (default Tax-only, the reference behavior; add ``"go"``
    for GO-term conditioning — BASELINE.json's ProGen-large capability).

    ``num_workers``: size of the ``multiprocessing`` pool used for record
    formatting and shard compression (the reference README's "utilize all
    cores" TODO, ``README.md:109``).  ``None`` -> ``os.cpu_count()``; ``0``
    or ``1`` -> serial.  Output bytes are identical for every worker count:
    per-record randomness is keyed by ``(seed, record_index)``, not by a
    shared stream.

    Workers use the ``spawn`` start method, so the caller's ``__main__``
    must be importable (a real script/module with an ``if __name__ ==
    '__main__'`` guard — true of ``generate_data.py`` and pytest; a
    stdin-piped ``python -`` session must pass ``num_workers<=1``).
    """
    import os

    if num_workers is None:
        num_workers = os.cpu_count() or 1

    # Spool encoded strings to one on-disk file, keeping only (offset, len)
    # per string in RAM — full-corpus Uniref50 emits tens of GB of strings,
    # which must not be held in memory (the reference staged one tmp gzip
    # file PER STRING, generate_data.py:76-79; one spool file is kinder to
    # the filesystem).
    import tempfile

    offsets: list[int] = []
    lengths: list[int] = []
    with tempfile.TemporaryFile() as spool:
        unknown = set(annotations) - set(EXTRACTORS)
        if unknown:
            raise ValueError(
                f"unknown annotation keys {sorted(unknown)}; "
                f"available: {sorted(EXTRACTORS)}")
        args = (
            (idx, desc, seq, prob_invert_seq_annotation, sort_annotations,
             tuple(annotations), seed)
            for idx, desc, seq in _filtered_records(
                read_from, max_seq_len, num_samples)
        )
        if num_workers > 1:
            # spawn (not fork): the parent may hold live runtimes
            # (torch's threads) whose locks do not survive fork.
            import multiprocessing as mp

            ctx = mp.get_context("spawn")
            with ctx.Pool(num_workers) as pool:
                string_lists = pool.imap(_format_record, args, chunksize=256)
                pos = _spool_strings(spool, string_lists, offsets, lengths)
        else:
            pos = _spool_strings(
                spool, map(_format_record, args), offsets, lengths)

        def read_string(i: int) -> bytes:
            spool.seek(offsets[i])
            return spool.read(lengths[i])

        n_strings = len(offsets)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n_strings)
        num_valid = math.ceil(fraction_valid_data * n_strings)
        valid_idx, train_idx = perm[:num_valid], perm[num_valid:]
        return _write_splits(
            write_to, read_string, train_idx, valid_idx,
            num_sequences_per_file, num_workers,
        )


def _spool_strings(spool, string_lists, offsets, lengths) -> int:
    pos = 0
    for strings in string_lists:
        for s in strings:
            spool.write(s)
            offsets.append(pos)
            lengths.append(len(s))
            pos += len(s)
    return pos


def _write_shard(args: tuple) -> None:
    """Pool worker: gzip-compress and write one complete shard file."""
    path, payloads = args
    write_tfrecord(path, payloads)


def _write_splits(write_to, read_string, train_idx, valid_idx,
                  num_sequences_per_file, num_workers=1):
    if str(write_to).startswith("gs://"):
        raise ValueError(f"{write_to}: gs:// paths are not ported (the port "
                         "has no GCS client); write to a local folder")
    out_dir = Path(write_to)
    if out_dir.exists():
        import shutil

        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    counts = {}

    def shard_tasks():
        for split, idx in (("train", train_idx), ("valid", valid_idx)):
            counts[split] = len(idx)
            if len(idx) == 0:
                continue
            num_shards = math.ceil(len(idx) / num_sequences_per_file)
            for file_index, shard_idx in enumerate(
                np.array_split(idx, num_shards)
            ):
                name = shard_filename(file_index, len(shard_idx), split)
                payloads = [read_string(int(i)) for i in shard_idx]
                yield str(out_dir / name), payloads

    if num_workers > 1:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        with ctx.Pool(num_workers) as pool:
            # imap over the lazy generator: at most ~num_workers shards'
            # payloads are pickled/in flight at once, never the full corpus
            for _ in pool.imap(_write_shard, shard_tasks(), chunksize=1):
                pass
    else:
        for task in shard_tasks():
            _write_shard(task)
    return counts
