"""Counter-based random numbers with ``jax.random``'s bits (the Threefry-2x32
generator of ``jax._src.prng``, with ``jax_threefry_partitionable=True``).

Algorithms 3-4 draw a sample of events and Bernoulli activations from a key;
an estimate is reproducible only if the port draws the same numbers. A key
is a ``(..., 2)`` int64 tensor holding two uint32 words. Every function is
elementwise integer arithmetic on tensors (int64 with explicit 32-bit masks),
so it gives the same bits on the CPU and on CUDA.

* :func:`PRNGKey`, :func:`split`, :func:`fold_in` — keys;
* :func:`random_bits` — uint32 words (returned as int64);
* :func:`uniform` — float32 or bfloat16 in ``[minval, maxval)`` by the
  mantissa transform; :func:`bernoulli` — ``uniform < p`` in float32;
* :func:`gumbel` and :func:`categorical` — ``jax.random.gumbel`` and the
  Gumbel-max draw of ``jax.random.categorical``, in float32 or bfloat16
  (serving's sampling at ``temperature > 0`` draws on bfloat16 logits);
* :func:`normal` — ``sqrt(2) * erf_inv(u)`` of a uniform ``u`` in
  ``[nextafter(-1, 0), 1)``, with XLA's single-precision ``erf_inv``
  (:func:`erf_inv`) on XLA CPU's float32 ``log1p``
  (:func:`repro_torch.floats.log1p`), so bit for bit
  ``jax.random.normal``, in float32 or bfloat16;
* :func:`randint` — int32 in ``[minval, maxval)`` from two 32-bit words
  combined modulo the span;
* :func:`permutation` and :func:`choice` (``replace=False``) — the
  multi-round stable sort by fresh 32-bit keys of ``jax.random``'s
  ``_shuffle``; :func:`choice` with ``p`` (``replace=True``) — the
  searchsorted of scaled uniforms in ``p``'s prefix sum.

A key may live on any device; every function draws on the key's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.floats import fma, log, log1p

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


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count pair ``(0, data)``.
    ``data`` is an int or an int64 tensor of words, broadcast with the
    key's batch axes (``key[..., None, :]`` and (C,) words give (..., C,
    2))."""
    words = torch.as_tensor(data, dtype=torch.int64,
                            device=key.device) & MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(words),
                          words)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` with 32-bit width: uint32 words of ``shape``,
    held in int64. A batch of keys (K, 2) gives (K, *shape), each row the
    bits of its own key (threefry is elementwise over keys)."""
    b1, b2 = _hash_counts(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0, dtype: torch.dtype = torch.float32
            ) -> torch.Tensor:
    """``jax.random.uniform`` in ``[minval, maxval)``, float32 or
    bfloat16. A batch of keys (K, 2) gives (K, *shape).

    * float32: the top 23 bits of each word as the mantissa of a float in
      [1, 2), minus 1, times ``maxval - minval`` plus ``minval`` in one
      fused multiply-add (XLA's CPU backend contracts them);
    * bfloat16: the low byte of each word (``nmant = 7 < 8``, so jax draws
      8 random bits), shifted right by one into the mantissa of a bfloat16
      in [1, 2): 128 values. Minus 1, then the scale and the shift, each op
      rounded to bfloat16 (compared with ``jax.random.uniform`` over
      several ranges, the separately rounded ops give its bits and a fused
      multiply-add does not); the bounds are rounded to float32 and then to
      bfloat16, as jax takes them."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"uniform draws float32 or bfloat16, got {dtype}")
    bits = random_bits(key, shape)
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    if dtype == torch.bfloat16:
        mant = ((bits & 0xFF) >> 1) | 0x3F80
        floats = mant.to(torch.int16).view(torch.bfloat16) - 1.0
        lo, hi = lo.to(dtype), hi.to(dtype)
        return torch.maximum(lo, floats * (hi - lo) + lo)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    # XLA's CPU backend fuses the scale and shift (one rounding)
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def gumbel(key: torch.Tensor, shape=(), dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` (its default ``mode="low"``)
    in float32 or bfloat16: ``-log(-log(u))`` of the :func:`uniform` ``u``
    in ``[tiny, 1)`` (``tiny`` the dtype's smallest normal), with XLA CPU's
    float32 ``log`` (:func:`repro_torch.floats.log`). In bfloat16 each
    ``log`` works on float32 and its result is rounded to bfloat16 before
    the next op: jax's jitted ``_gumbel`` rounds so under the test
    process's default XLA flags (one rounding at the end differs in most
    draws). A batch of keys (K, 2) gives (K, *shape)."""
    tiny = float(torch.finfo(dtype).tiny)
    u = uniform(key, shape, minval=tiny, maxval=1.0, dtype=dtype)
    inner = -log(u.float()).to(dtype)
    return -log(inner.float()).to(dtype)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` (with replacement,
    ``mode="low"``) on float32 or bfloat16 logits: the index of the
    largest ``gumbel(key, logits.shape, logits.dtype) + logits`` along the
    last axis, the sum in the logits' dtype, the first index on a tie (the
    bfloat16 Gumbel noise takes 128 values, so ties are common). Drawn on
    the key's device, which must be the logits'. Returns int64."""
    noise = gumbel(key, tuple(logits.shape), logits.dtype)
    return torch.argmax(noise + logits, dim=-1)


# Giles' single-precision erf_inv polynomials (XLA's ErfInv32), highest
# degree first: for w < 5 in w - 2.5, else in sqrt(w) - 3
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` of float32 ``x`` as XLA's CPU backend computes
    it: ``w = -log1p(-x * x)``, Giles' polynomial in ``w - 2.5`` (``w <
    5``) or ``sqrt(w) - 3``, Horner with one rounding a step, times ``x``;
    ``+-inf`` at ``x = +-1``."""
    x = x.to(torch.float32)
    w = -log1p(x * -x)
    lt = w < 5.0
    # float64's square root rounded to float32 is the correctly rounded
    # float32 one (torch's float32 sqrt on the CPU is not always)
    t = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    dev = x.device
    coef = lambda i: torch.where(
        lt, torch.tensor(_ERF_INV_LT5[i], dtype=torch.float32, device=dev),
        torch.tensor(_ERF_INV_GE5[i], dtype=torch.float32, device=dev))
    p = coef(0)
    for i in range(1, len(_ERF_INV_LT5)):
        p = fma(p, t, coef(i))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_LO_BF16 = -1.0 + 2.0 ** -8       # bfloat16's nextafter(-1, 0)


def normal(key: torch.Tensor, shape=(), dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` in float32 or bfloat16:
    ``sqrt(2) * erf_inv(u)`` with ``u`` the :func:`uniform` in
    ``[nextafter(-1, 0), 1)`` of the dtype. In float32 the product is
    ``float32(sqrt(2)) * erf_inv(u)``; in bfloat16 ``u`` is a bfloat16
    uniform, ``erf_inv`` works in float32 and is rounded to bfloat16, and
    the product with ``bfloat16(sqrt(2))`` is rounded again (compared with
    ``jax.random.normal``, rounding each op gives its bits). A batch of
    keys (K, 2) gives (K, *shape)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"normal draws float32 or bfloat16, got {dtype}")
    lo = _NORMAL_LO if dtype == torch.float32 else _NORMAL_LO_BF16
    u = uniform(key, shape, minval=lo, maxval=1.0, dtype=dtype)
    sqrt2 = torch.tensor(np.sqrt(2.0), dtype=torch.float32, device=u.device)
    if dtype == torch.bfloat16:
        return erf_inv(u.float()).to(dtype) * sqrt2.to(dtype)
    return erf_inv(u) * sqrt2


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
    in uint32 arithmetic (wrapping), modulo the span once more. A batch
    of keys (K, 2) gives (K, *shape), each row its own key's draw."""
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise ValueError("randint takes int32 bounds")
    keys = split(key)
    k1, k2 = keys[..., 0, :], keys[..., 1, :]
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
    32-bit words drawn from the second key of a split. A batch of keys
    (K, 2) gives (K, n), each row its own key's permutation."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        key.shape[:-1] + (n,))
    for _ in range(rounds):
        keys = split(key)
        key, subkey = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(subkey, (n,)), stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def _searchsorted_left(sorted_arr: torch.Tensor,
                       query: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(sorted_arr, query)`` (``side="left"``, its default
    ``method="scan"``): ``ceil(log2(n + 1))`` bisection steps from ``(low,
    high) = (0, n)``, ``mid = (low + high) // 2``, going left where ``query
    <= sorted_arr[mid]``; returns ``high``. The same steps as ``jnp``'s, so
    the same index even where rounding left the array not quite sorted."""
    n = sorted_arr.shape[0]
    low = torch.zeros(query.shape, dtype=torch.int64, device=query.device)
    high = torch.full(query.shape, n, dtype=torch.int64, device=query.device)
    for _ in range(int(np.ceil(np.log2(n + 1)))):
        mid = (low + high) // 2
        left = query <= sorted_arr[mid.clamp(max=n - 1)]
        low, high = torch.where(left, low, mid), torch.where(left, mid, high)
    return high


def choice(key: torch.Tensor, n: int, size, *, replace: bool = False,
           p: torch.Tensor | None = None) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=replace, p=p)`` for the
    two forms the ported paths draw:

    * ``replace=False`` without ``p``: the first ``size`` entries of
      :func:`permutation` (int64; a batch of keys (K, 2) gives (K,
      *shape), each row its own key's draw);
    * ``replace=True`` with ``p`` (float32, (n,)): ``p``'s prefix sum in
      XLA CPU's order (:func:`repro_torch.core.segments.xla_cumsum`),
      ``r = cumsum[-1] * (1 - uniform(key, shape))``, and the index of
      each ``r`` by ``jnp.searchsorted``'s bisection, side left (int32).

    ``size`` is an int or a shape. ``replace=False`` with ``p`` (the Gumbel
    top-k) and ``replace=True`` without it raise ``NotImplementedError``:
    no ported path draws them (ROADMAP.md queue 1, item 10)."""
    shape = (size,) if isinstance(size, int) else tuple(size)
    if p is not None:
        if not replace:
            raise NotImplementedError(
                "choice(replace=False, p=...) is not ported to repro_torch "
                "yet; see ROADMAP.md queue 1, item 10")
        from repro_torch.core.segments import xla_cumsum
        p = torch.as_tensor(p, dtype=torch.float32).to(key.device)
        if tuple(p.shape) != (n,):
            raise ValueError(
                "p must be None or a 1D vector with the same size as "
                f"a.shape[axis]. p has shape {tuple(p.shape)} and "
                f"a.shape[axis] is {n}.")
        cum = xla_cumsum(p[:, None])[:, 0]
        r = cum[-1] * (1 - uniform(key, shape))
        return _searchsorted_left(cum, r).to(torch.int32)
    if replace:
        raise NotImplementedError(
            "choice(replace=True) without p is not needed by the ported "
            "path; see ROADMAP.md queue 1, item 10")
    count = math.prod(shape)
    if count > n:
        raise ValueError(
            f"Cannot take a larger sample (size {count}) than population "
            f"(size {n}) when 'replace=False'")
    return permutation(key, n)[..., :count].reshape(key.shape[:-1] + shape)
