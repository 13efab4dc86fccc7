"""Counter-based random numbers with ``jax.random``'s bits (the Threefry-2x32
generator of ``jax._src.prng``, with ``jax_threefry_partitionable=True``).

Algorithms 3-4 draw a sample of events and Bernoulli activations from a key;
an estimate is reproducible only if the port draws the same numbers. A key
is a ``(..., 2)`` int64 tensor holding two uint32 words. Every function is
elementwise integer arithmetic on tensors (int64 with explicit 32-bit masks),
so it gives the same bits on the CPU and on CUDA.

* :func:`PRNGKey`, :func:`split`, :func:`fold_in` — keys;
* :func:`random_bits` — uint32 words (returned as int64);
* :func:`uniform` — float32 in ``[minval, maxval)`` by the mantissa
  transform; :func:`bernoulli` — ``uniform < p`` in float32;
* :func:`randint` — int32 in ``[minval, maxval)`` from two 32-bit words
  combined modulo the span;
* :func:`permutation` and :func:`choice` (``replace=False``) — the
  multi-round stable sort by fresh 32-bit keys of ``jax.random``'s
  ``_shuffle``.

``normal`` (through erfinv) is not here yet; it arrives with the
common-random-numbers scenario families (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.floats import fma

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x1, x2)``
    under the key words ``(k1, k2)``, all uint32 values held in int64 and
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(step + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(step + 2) % 3] + step + 1) & MASK
    return x[0], x[1]


def PRNGKey(seed: int, *, device: DeviceLike = "cpu") -> torch.Tensor:
    """The key of ``jax.random.PRNGKey(seed)`` for a 32-bit integer seed:
    ``[0, seed mod 2**32]``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the 32-bit integer range")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _counts(shape, device):
    """``iota_2x32_shape``: the row-major index of every element of
    ``shape`` as (high, low) 32-bit words."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & MASK


def _hash_counts(key: torch.Tensor, shape):
    """Threefry of the counts of ``shape`` under ``key`` (..., 2); the key's
    batch axes lead the result's."""
    hi, lo = _counts(tuple(shape), key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys, (num, 2)."""
    b1, b2 = _hash_counts(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count pair ``(0, data)``."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], zero,
                          zero + (int(data) & MASK))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` with 32-bit width: uint32 words of ``shape``,
    held in int64. A batch of keys (K, 2) gives (K, *shape), each row the
    bits of its own key (threefry is elementwise over keys)."""
    b1, b2 = _hash_counts(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits of each word as
    the mantissa of a float in [1, 2), minus 1, scaled to ``[minval,
    maxval)``. A batch of keys (K, 2) gives (K, *shape)."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA's CPU backend fuses the scale and shift (one rounding)
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def bernoulli(key: torch.Tensor, p: float = 0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``: a float32
    :func:`uniform` below ``float32(p)``."""
    p32 = torch.tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < p32


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) for
    int32 bounds: two words from the keys of a :func:`split` (high, low),
    each reduced modulo the span ``maxval - minval`` (1 when ``maxval <=
    minval``), combined as ``(hi % span) * (2**32 % span) + lo % span``
    in uint32 arithmetic (wrapping), modulo the span once more."""
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise ValueError("randint takes int32 bounds")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    multiplier = (((2 ** 16 % span) ** 2) & MASK) % span
    offset = (((higher % span) * multiplier) & MASK) + lower % span
    offset = (offset & MASK) % span
    # int32 result: minval + offset wraps as jnp's int32 add does
    out = (minval + offset) & MASK
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int64) shuffled
    by ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each a stable sort by fresh
    32-bit words drawn from the second key of a split."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, subkey = split(key)
        order = torch.sort(random_bits(subkey, (n,)), stable=True).indices
        x = x[order]
    return x


def choice(key: torch.Tensor, n: int, size: int, *,
           replace: bool = False) -> torch.Tensor:
    """``jax.random.choice(key, n, (size,), replace=False)``: the first
    ``size`` entries of :func:`permutation`."""
    if replace:
        raise NotImplementedError(
            "choice(replace=True) is not needed by the ported path")
    if size > n:
        raise ValueError(
            f"Cannot take a larger sample (size {size}) than population "
            f"(size {n}) when 'replace=False'")
    return permutation(key, n)[:size]
