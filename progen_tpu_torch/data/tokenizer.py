"""Byte-level tokenizer (ported from progen_tpu/data/tokenizer.py).

Token id = ``ord(ch) + 1``; id 0 is reserved and triple-duty as
pad / BOS / EOS; decoding subtracts the offset and drops ids that map
below zero (i.e. the 0s).  Vocabulary of 256 covers shifted bytes 0-254.
"""

from __future__ import annotations

import numpy as np

PAD_ID = 0
OFFSET = 1
VOCAB_SIZE = 256


def encode_token(ch: str) -> int:
    return ord(ch) + OFFSET


def encode_tokens(s: str) -> list[int]:
    return [encode_token(ch) for ch in s]


def decode_token(tok: int, offset: int = OFFSET) -> str:
    t = int(tok) - offset
    if t < 0:
        return ""
    return chr(t)


def decode_tokens(tokens, offset: int = OFFSET) -> str:
    tokens = np.asarray(tokens).astype(np.int32)
    return "".join(decode_token(t, offset) for t in tokens)
