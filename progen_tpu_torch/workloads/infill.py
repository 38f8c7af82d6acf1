"""Constrained span-infilling: scaffold templates -> per-position logit masks
(copied from progen_tpu/workloads/infill.py, which is numpy only; the copy is
pinned to the original by tests/test_torch_workloads.py).

Protein engineering's scaffold-constrained design: a template fixes some
positions to known residues (the scaffold), leaves spans free (the design
region), and optionally restricts free positions to a sub-alphabet
(e.g. hydrophobics only).  :class:`ScaffoldSpec` is the host-side API: it
splits the template into the prime (the longest frozen prefix, served
through the normal prefill path, no masking needed) and a ``(G, V)``
boolean mask over the ``G`` generated positions, where a frozen position
is a one-hot row (the sampler is FORCED to emit it) and a free position
allows its alphabet.

The mask is pure data (numpy) so specs build anywhere and serialize
through the wire helpers below.  Engine-side semantics live in
``decode/sampler.apply_logit_mask``: an all-pass mask is bit-identical to
no mask at all.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


@dataclasses.dataclass(frozen=True)
class ScaffoldSpec:
    """A scaffold-constrained infilling request.

    ``template``: one entry per sequence position —

    * an ``int`` token id: frozen scaffold position (forced);
    * ``None``: free position over ``alphabet`` (or the full vocab);
    * an iterable of token ids: free position over that allowed set.

    ``alphabet``: default allowed set for ``None`` entries (``None`` =
    full vocabulary).  ``vocab``: vocabulary size ``V``.

    The longest all-``int`` prefix becomes the prime (at least one
    position — the engine needs a non-empty prime; start templates with
    a BOS/context token).  Everything after it is generated under the
    mask, INCLUDING interior frozen positions (a one-hot row forces the
    scaffold token regardless of key/top-k/temperature).
    """

    template: Sequence
    vocab: int = 256
    alphabet: Iterable[int] | None = None

    def __post_init__(self):
        if len(self.template) < 2:
            raise ValueError("template needs at least a prime position and "
                             "one position to generate")
        if not _is_int(self.template[0]):
            raise ValueError(
                "template must start with at least one frozen token (the "
                "prime the engine prefills); got a free position at index 0")
        if len(self.prime()) == len(self.template):
            raise ValueError("template is fully frozen — nothing to infill")
        for g, row in enumerate(self._rows()):
            if not row.any():
                raise ValueError(
                    f"template position {len(self.prime()) + g} allows no "
                    "tokens — every generated position needs >= 1")

    def prime(self) -> list[int]:
        """The longest frozen prefix, served as the request's prime."""
        out: list[int] = []
        for e in self.template:
            if not _is_int(e):
                break
            out.append(int(e))
        return out

    @property
    def max_new_tokens(self) -> int:
        return len(self.template) - len(self.prime())

    def _rows(self):
        v = self.vocab
        default = np.zeros(v, bool)
        if self.alphabet is None:
            default[:] = True
        else:
            idx = np.asarray(sorted(set(int(a) for a in self.alphabet)),
                             np.int64)
            if idx.size and (idx.min() < 0 or idx.max() >= v):
                raise ValueError(f"alphabet outside vocab {v}")
            default[idx] = True
        for e in self.template[len(self.prime()):]:
            row = np.zeros(v, bool)
            if e is None:
                row = default.copy()
            elif _is_int(e):
                if not (0 <= int(e) < v):
                    raise ValueError(f"frozen token {e} outside vocab {v}")
                row[int(e)] = True
            else:
                idx = np.asarray(sorted(set(int(a) for a in e)), np.int64)
                if idx.size == 0:
                    yield row
                    continue
                if idx.min() < 0 or idx.max() >= v:
                    raise ValueError(f"allowed set {e} outside vocab {v}")
                row[idx] = True
            yield row

    def logit_mask(self) -> np.ndarray:
        """``(max_new_tokens, V)`` bool: row ``g`` constrains the token
        generated at template position ``len(prime) + g``."""
        return np.stack(list(self._rows()), axis=0)

    def request_kwargs(self) -> dict:
        """Keyword arguments for ``decode.engine.Request`` (tokens,
        max_new_tokens, logit_mask) — kept as plain data so this module
        never imports the engine."""
        return {
            "tokens": self.prime(),
            "max_new_tokens": self.max_new_tokens,
            "logit_mask": self.logit_mask(),
        }

    def full_mask(self, length: int) -> np.ndarray:
        """``(length, V)`` absolute-position mask for
        ``make_chunked_sampler``'s ``logit_mask``: generated template
        positions carry their rows, everything else is all-pass (prime
        positions are never sampled; positions past the template are
        unconstrained)."""
        p = len(self.prime())
        if length < p + self.max_new_tokens:
            raise ValueError(
                f"length {length} shorter than template {len(self.template)}")
        out = np.ones((length, self.vocab), bool)
        out[p:p + self.max_new_tokens] = self.logit_mask()
        return out


def mask_to_wire(mask) -> list | None:
    """Compact JSON-safe encoding of a ``(G, V)`` bool mask: per position,
    ``None`` for an all-pass row, else the sorted list of allowed ids.
    ``None`` for a ``None``/all-pass mask (the common generate case costs
    zero bytes on the wire)."""
    if mask is None:
        return None
    mask = np.asarray(mask, bool)
    rows = [None if row.all() else np.flatnonzero(row).tolist()
            for row in mask]
    if all(r is None for r in rows):
        return None
    return rows


def mask_from_wire(rows, vocab: int) -> np.ndarray | None:
    """Inverse of :func:`mask_to_wire`."""
    if rows is None:
        return None
    out = np.ones((len(rows), vocab), bool)
    for g, r in enumerate(rows):
        if r is not None:
            out[g] = False
            out[g, np.asarray(r, np.int64)] = True
    return out
