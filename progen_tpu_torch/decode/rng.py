"""The JAX key chain in PyTorch integer arithmetic: threefry2x32 keys,
``split``, 32-bit random bits, uniform and Gumbel draws that reproduce
``jax.random`` (threefry, ``jax_threefry_partitionable=True``) bit for bit.

The serving engine needs noise that is a pure function of a per-request
key: a request's tokens may depend only on (params, prime, seed, knobs),
never on its slot or its neighbours, so every slot carries its own key as
data and advances it only on its own live steps.  A ``torch.Generator`` is
one global stream and cannot do that.

Keys are RAW key data, two uint32 words per key, held in an **int64**
tensor ``(..., 2)`` with every value in ``[0, 2^32)``: uint32 arithmetic is
done in int64 and masked to 32 bits after each add and shift (PyTorch has
no uint32 arithmetic; int64 keeps the logical right shift free of sign
extension).  Every function is vectorised over the leading dimensions and
runs on the key tensor's device, with no host synchronisation.

What is reproduced (JAX 0.9 names): ``threefry2x32`` (the 20-round hash),
``key`` (``jax.random.key`` of a uint32 seed: words ``[0, seed]``),
``split`` (``_threefry_split_foldlike``: the hash of counters
``(0, 0), (0, 1)``), ``random_bits`` (``_threefry_random_bits_partitionable``
at 32 bits for shape ``(n,)``: counters ``(0, i)``, the two output words
XORed), ``uniform`` (``_uniform``: 23 mantissa bits under exponent 0) and
``gumbel`` (the default ``"low"`` mode of ``_gumbel``).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counters ``(x1, x2)`` under key
    ``(k1, k2)``: int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = ((b << r) | (b >> (32 - r))) & _MASK
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.key(uint32 seed)`` as raw key data: ``seed (...)`` int
    -> ``(..., 2)`` int64 ``[0, seed mod 2^32]``."""
    low = seed.to(torch.int64) & _MASK
    return torch.stack([torch.zeros_like(low), low], dim=-1)


def _hash_counters(keys: torch.Tensor, n: int):
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    counts = counts.expand(*keys.shape[:-1], n)
    return threefry2x32(keys[..., 0:1], keys[..., 1:2],
                        torch.zeros_like(counts), counts)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``keys (..., 2)`` -> ``(..., num, 2)``."""
    a, b = _hash_counters(keys, num)
    return torch.stack([a, b], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits for shape ``(n,)`` per key: ``(..., n)`` int64."""
    a, b = _hash_counters(keys, n)
    return a ^ b


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per key:
    the top 23 bits become the mantissa of a float in ``[1, 2)``, minus 1,
    scaled, and floored at ``minval``."""
    bits = (random_bits(keys, n) >> 9) | _F32_ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # the span in f32, as JAX takes it; Python scalars keep the device free
    # of host copies
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    return (floats * span + float(lo)).clamp_min(float(lo))


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per key:
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(keys, n, _F32_TINY, 1.0)))
