"""Float32 arithmetic that rounds where the reference's compiled code does.

XLA's CPU backend contracts a float32 ``a * b + c`` inside one fused loop
into a fused multiply-add, which rounds once. Where ``repro`` computes such
an expression (Algorithm 4's step and update, ``jax.random.uniform``'s
scale and shift), the port must round once too, or a last bit differs and
the estimate drifts. PyTorch has no elementwise fused multiply-add, so
:func:`fma` computes it exactly in float64 with round-to-odd, which makes
the final rounding to float32 the correctly rounded one. The operands are
elementwise, so CPU and CUDA tensors give the same bits.

XLA's CPU backend also brings its own float32 ``log``, ``log1p`` and
``exp``: Cephes polynomials in which the compiler contracts each
multiply-add it can into a fused one. :func:`log`, :func:`log1p` and
:func:`exp` repeat them operation for operation from ``+ - * /``,
:func:`fma`, ``floor``, compares and selects, all IEEE on both devices, so
they give ``jnp.log1p``'s and ``jnp.exp``'s bits where ``torch.log1p`` and
``torch.exp`` differ in the last bit (18% and 9.6% of float32 inputs).
``jax.random.normal``, ``jax.random.gumbel`` and the bid noise of the
scenario families reach them through :mod:`repro_torch.prng` and
:mod:`repro_torch.core.crn`.

Three more orders of XLA's CPU backend that the keyed synthetic and
Yahoo-like days (:mod:`repro_torch.data`) meet:

* :func:`xla_sum` — a float32 sum over a vector, rewritten by XLA as
  windows of 32 summed in order, then the window totals the same way;
* :func:`xla_dot` — a ``(M, K) @ (N, K).T`` product, whose kernel XLA picks
  by (N, K): a chain of fused multiply-adds over k, or 2, 4 or 8
  interleaved chains added at the end (:data:`DOT_CHAINS`, measured; an
  (N, K) outside it is refused, not guessed);
* :func:`powf` — ``x ** y``, which XLA's compiled code hands to the C
  library's ``powf``.
"""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np
import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding (broadcasting)."""
    x = a.double() * b.double()           # exact: 24 + 24 bits < 53
    y = c.double()
    s = x + y
    # TwoSum: the exact error of the float64 sum
    t = s - x
    err = (x - (s - t)) + (y - t)
    # round to odd: an inexact sum whose last bit is even moves one ulp
    # towards the exact value, so the rounding to float32 is the only one
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).double()
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int32).view(torch.float32)


# Cephes' float32 log, in the order XLA CPU evaluates it: three pairs of
# coefficients, each pair one fused multiply-add, combined by Estrin's scheme
_LOG_P = ((7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1),
          (-1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1),
          (2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# Cephes' rational log1p for small arguments, Horner in float32
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log(x1: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log`` of ``x1`` (``jnp.log``): the exponent
    split off, the mantissa moved into [sqrt(1/2), sqrt(2)), Cephes'
    polynomial. ``jax.random.gumbel`` reaches it through
    :func:`repro_torch.prng.gumbel`."""
    tiny = _f32(1.17549435e-38, x1)                 # smallest normal
    xc = torch.where(x1 > tiny, x1, tiny)
    bits = xc.view(torch.int32).to(torch.int64)
    m = _bits_to_f32((bits & 0x7FFFFF) | 0x3F000000)            # [0.5, 1)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    small = m < _f32(0.707106769, x1)
    e = torch.where(small, e - 1.0, e)
    x = (m + _f32(-1.0, x1)) + torch.where(small, m, torch.zeros_like(m))
    z = x * x
    x3 = x * z
    q = [fma(fma(x, _f32(a, x1), _f32(b, x1)), x, _f32(c, x1))
         for a, b, c in _LOG_P]
    r = fma(fma(q[0], x3, q[1]), x3, q[2])
    t = fma(r, x3, e * _f32(_LOG_Q1, x1))
    y = fma(_f32(-0.5, x1), z, x) + t
    y = fma(e, _f32(_LOG_Q2, x1), y)
    inf = float("inf")
    y = torch.where((x1 <= 0) | torch.isnan(x1), float("nan"), y)
    y = torch.where(x1 == 0, -inf, y)
    return torch.where(x1 == inf, inf, y)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of float32 ``x`` on XLA's CPU backend: ``log(1 + x)``
    (:func:`log`) where ``|x| >= sqrt(2) - 1``, else Cephes' rational
    approximation ``x - x^2/2 + x^3 P(x)/Q(x)``."""
    x = x.to(torch.float32)
    large = log(x + 1.0)
    x2 = x * x
    zero = x * 0.0
    den = zero + _f32(_LOG1P_DEN[0], x)
    for c in _LOG1P_DEN[1:]:
        den = fma(den, x, _f32(c, x))
    num = zero + _f32(_LOG1P_NUM[0], x)
    for c in _LOG1P_NUM[1:]:
        num = fma(num, x, _f32(c, x))
    small = x + fma(_f32(-0.5, x), x2, (x * x2) * (num / den))
    return torch.where(torch.abs(x) < _f32(0.41421356, x), small, large)


_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 0.5)


def exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of float32 ``x`` on XLA's CPU backend: ``x`` clamped to
    [-87.8, 88.8], ``n = floor(x log2(e) + 1/2)`` clamped to [-127, 127],
    Cody-Waite reduction by ln 2 in two parts, Cephes' degree-5 polynomial,
    then the product with ``2^n`` built from its exponent bits, a result
    below the smallest normal flushed to zero as XLA's CPU code flushes
    denormals."""
    x = x.to(torch.float32)
    x = torch.clamp(x, -87.8, 88.8)
    n = torch.floor(fma(x, _f32(1.44269504, x), _f32(0.5, x)))
    n = torch.clamp(n, -127.0, 127.0)
    r = fma(-n, _f32(0.693359375, x), x)
    r = fma(-n, _f32(-2.12194440e-4, x), r)
    p = fma(r, _f32(_EXP_P[0], x), _f32(_EXP_P[1], x))
    for c in _EXP_P[2:]:
        p = fma(p, r, _f32(c, x))
    y = fma(p, r * r, r) + 1.0
    scale = _bits_to_f32((n.to(torch.int64) + 127) << 23)
    out = y * scale
    return torch.where(out < _f32(1.17549435e-38, x), 0.0, out)


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` of a float32 vector on XLA's CPU backend: a vector of
    more than 32 floats is padded with zeros (half the padding in front) to
    whole windows of 32, each window summed in order from 0, and the
    window totals summed by the same rule; at most 32 floats are summed in
    order from 0."""
    x = x.to(torch.float32)
    n = x.shape[0]
    if n <= 32:
        acc = x.new_zeros(())
        for v in x:
            acc = acc + v
        return acc
    windows = -(-n // 32)
    pad = windows * 32 - n
    x = torch.cat([x.new_zeros(pad // 2), x, x.new_zeros(pad - pad // 2)])
    x = x.reshape(windows, 32)
    acc = x.new_zeros(windows)
    for j in range(32):
        acc = acc + x[:, j]
    return xla_sum(acc)


# How many interleaved multiply-add chains XLA CPU's (M, K) @ (N, K).T
# kernel keeps (jax 0.9.0 on an x86 CPU), by K (the contracted width) and
# N, for M >= 2 rows (M = 1 is one chain). Measured by
# ``tests/measure_dot_chains.py`` against jax for K = 1 ... 64: every
# N <= DOT_MEASURED_N, 256 sampled N above it up to DOT_SAMPLED_N, and
# three N at 4,096 rows. A K's string is run-length codes "chains*count"
# over N = 1, 2, ...; then "|" and, where the codes repeat past
# DOT_MEASURED_N (every sample fitting), the repeating unit's codes over N
# mod its length. "0" marks an N no chain count matched (N = 1 at some
# K >= 8). Chain j of u adds k = j, j+u, ... as fused multiply-adds from
# its first product; the chains are added pairwise, and the K mod u
# products left over are added in order and then added to that. Where
# the table has no count :func:`dot_chains` returns None and
# :func:`xla_dot` raises.
DOT_MEASURED_N = 1024
DOT_SAMPLED_N = 16_384
DOT_CHAINS = {
    1: '1*1024 | 1*1',
    2: '1*1024 | 1*1',
    3: '1*1024 | 1*1',
    4: '1*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    5: '1*1 4*15 2*16 1*32 2*32 1*928 | 1*1',
    6: '1*1 4*15 2*16 ' + '1*32 2*32 ' * 15 + '1*32 | 1*1 2*32 1*31',
    7: '1*1 4*23 2*8 4*16 1*16 4*16 2*16 1*32 4*16 2*16 1*32 4*16 '
        + '1*48 4*16 1*752 | 1*1',
    8: '8*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    9: '8*1 4*15 2*16 ' + '1*32 2*32 ' * 3 + '1*800 | 1*1',
    10: '0*1 4*15 2*16 4*16 1*16 ' + '2*32 1*32 ' * 15 + '| 1*1 2*32 1*31',
    11: '0*1 4*23 2*8 4*16 1*16 4*16 2*16 4*16 1*16 4*16 2*16 1*32 '
        + '4*16 2*16 1*32 4*16 2*16 1*32 4*16 1*48 4*16 1*48 4*16 '
        + '1*560 | 1*1',
    12: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    13: '0*1 4*15 2*16 4*16 1*16 4*16 2*16 ' + '1*32 2*32 ' * 4
        + '1*672 | 1*1',
    14: '0*1 4*15 2*16 4*16 1*16 4*16 2*16 ' + '1*32 2*32 ' * 14
        + '1*32 | 1*1 2*32 1*31',
    15: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 3
        + '1*32 4*16 2*16 1*32 4*16 2*16 1*32 4*16 2*16 1*32 '
        + '4*16 1*48 ' * 3 + '4*16 1*368 | 1*1',
    16: '8*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    17: '8*1 4*15 2*16 4*16 1*16 4*16 2*16 ' + '1*32 2*32 ' * 6
        + '1*544 | 1*1',
    18: '8*1 4*15 2*16 4*16 1*16 4*16 2*16 4*16 1*16 ' + '2*32 1*32 ' * 14
        + '| 1*1 2*32 1*31',
    19: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 4
        + '1*32 4*16 2*16 1*32 4*16 2*16 1*32 4*16 2*16 1*32 4*16 2*16 '
        + '1*32 ' + '4*16 1*48 ' * 4 + '4*16 1*176 |',
    20: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    21: '0*1 4*15 2*16 4*16 1*16 4*16 2*16 1*32 4*16 2*16 '
        + '1*32 2*32 ' * 7 + '1*416 | 1*1',
    22: '0*1 4*15 2*16 4*16 1*16 4*16 2*16 4*16 1*16 4*16 2*16 '
        + '1*32 2*32 ' * 13 + '1*32 | 1*1 2*32 1*31',
    23: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 5
        + '1*32 4*16 2*16 1*32 4*16 2*16 1*32 4*16 2*16 1*32 4*16 2*16 '
        + '1*32 4*16 2*16 1*32 ' + '4*16 1*48 ' * 5 + '|',
    24: '8*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    25: '8*1 4*15 2*16 4*16 1*16 4*16 2*16 4*16 1*16 4*16 2*16 '
        + '1*32 2*32 ' * 9 + '1*288 | 1*1',
    26: '0*1 4*15 2*16 4*16 1*16 4*16 2*16 4*16 1*16 4*16 2*16 4*16 '
        + '1*16 ' + '2*32 1*32 ' * 13 + '| 1*1 2*32 1*31',
    27: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 6
        + '1*32 4*16 2*16 1*32 4*16 2*16 ' * 3 + '1*32 ' + '4*16 1*48 ' * 3
        + '|',
    28: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    29: '0*1 4*15 2*16 4*16 1*16 4*16 2*16 4*16 1*16 4*16 2*16 1*32 '
        + '4*16 2*16 ' + '1*32 2*32 ' * 10 + '1*160 |',
    30: '0*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 3 + '2*16 '
        + '1*32 2*32 ' * 12 + '1*32 | 1*1 2*32 1*31',
    31: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 7
        + '1*32 4*16 2*16 1*32 4*16 2*16 ' * 3
        + '1*32 4*16 2*16 1*32 4*16 1*48 |',
    32: '8*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    33: '8*1 4*15 2*16 4*16 1*16 4*16 2*16 4*16 1*16 4*16 2*16 1*32 '
        + '4*16 2*16 ' + '1*32 2*32 ' * 12 + '1*32 |',
    34: '0*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 3 + '2*16 4*16 1*16 '
        + '2*32 1*32 ' * 12 + '| 1*1 2*32 1*31',
    35: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 8
        + '1*32 4*16 2*16 1*32 4*16 2*16 ' * 3 + '1*32 4*16 2*16 1*32 |',
    36: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    37: '0*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 3 + '2*16 1*32 4*16 2*16 '
        + '1*32 2*32 ' * 11 + '1*32 |',
    38: '0*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 4 + '2*16 '
        + '1*32 2*32 ' * 11 + '1*32 | 1*1 2*32 1*31',
    39: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 9
        + '1*32 4*16 2*16 1*32 4*16 2*16 ' * 3 + '1*32 |',
    40: '8*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    41: '8*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 3 + '2*16 1*32 4*16 2*16 '
        + '1*32 2*32 ' * 11 + '1*32 |',
    42: '8*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 4 + '2*16 4*16 1*16 '
        + '2*32 1*32 ' * 11 + '| 1*1 2*32 1*31',
    43: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 10
        + '1*32 4*16 2*16 1*32 4*16 2*16 1*32 4*16 2*16 1*32 4*16 2*16 '
        + '1*32 4*16 2*16 1*32 |',
    44: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    45: '0*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 3
        + '2*16 1*32 4*16 2*16 1*32 4*16 2*16 ' + '1*32 2*32 ' * 10
        + '1*32 |',
    46: '0*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 5 + '2*16 '
        + '1*32 2*32 ' * 10 + '1*32 | 1*1 2*32 1*31',
    47: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 11
        + '1*32 4*16 2*16 1*32 4*16 2*16 1*32 4*16 2*16 1*32 4*16 2*16 '
        + '1*32 |',
    48: '8*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    49: '8*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 4 + '2*16 1*32 4*16 2*16 '
        + '1*32 2*32 ' * 10 + '1*32 |',
    50: '8*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 5 + '2*16 4*16 1*16 '
        + '2*32 1*32 ' * 10 + '| 1*1 2*32 1*31',
    51: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 12
        + '1*32 4*16 2*16 1*32 4*16 2*16 1*32 4*16 2*16 1*32 |',
    52: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    53: '0*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 4
        + '2*16 1*32 4*16 2*16 1*32 4*16 2*16 ' + '1*32 2*32 ' * 9 + '1*32 |',
    54: '0*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 6 + '2*16 ' + '1*32 2*32 ' * 9
        + '1*32 | 1*1 2*32 1*31',
    55: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 13
        + '1*32 4*16 2*16 1*32 4*16 2*16 1*32 |',
    56: '8*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    57: '8*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 4
        + '2*16 1*32 4*16 2*16 1*32 4*16 2*16 ' + '1*32 2*32 ' * 9 + '1*32 |',
    58: '8*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 6 + '2*16 4*16 1*16 '
        + '2*32 1*32 ' * 9 + '| 1*1 2*32 1*31',
    59: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 14
        + '1*32 4*16 2*16 1*32 |',
    60: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
    61: '0*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 5
        + '2*16 1*32 4*16 2*16 1*32 4*16 2*16 ' + '1*32 2*32 ' * 8 + '1*32 |',
    62: '0*1 4*15 ' + '2*16 4*16 1*16 4*16 ' * 7 + '2*16 ' + '1*32 2*32 ' * 8
        + '1*32 | 1*1 2*32 1*31',
    63: '0*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15 + '1*32 |',
    64: '8*1 4*23 2*8 ' + '4*16 1*16 4*16 2*16 ' * 15
        + '4*16 1*16 | 1*1 4*16 2*16 4*16 1*15',
}


def _run_length_at(codes: str, i: int):
    """The value at 0-based position ``i`` of run-length ``codes``, or
    None past their end."""
    for code in codes.split():
        value, count = code.split("*")
        i -= int(count)
        if i < 0:
            return int(value)
    return None


def dot_chains(m: int, n: int, k: int):
    """The number of chains of :data:`DOT_CHAINS` for an (m, k) @ (n, k).T
    product: 1 where m is 1, None where the table has no measured count."""
    if m < 2:
        return 1
    entry = DOT_CHAINS.get(k)
    if entry is None:
        return None
    head, _, unit = entry.partition("|")
    if n <= DOT_MEASURED_N:
        u = _run_length_at(head, n - 1)
    elif unit.strip() and n <= DOT_SAMPLED_N:
        length = sum(int(code.split("*")[1]) for code in unit.split())
        u = _run_length_at(unit, n % length)
    else:
        u = None
    return u or None


def xla_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` for float32 ``a`` (M, K) and ``b`` (N, K) in the order of
    XLA CPU's kernel (:data:`DOT_CHAINS`), elementwise float32 operations
    and :func:`fma`, so the CPU and CUDA give the same bits. Raises
    ``ValueError`` for an (N, K) whose order was not measured."""
    m, k = a.shape
    n = b.shape[0]
    u = dot_chains(m, n, k)
    if u is None:
        raise ValueError(
            f"XLA CPU's order of an ({m}, {k}) @ ({n}, {k}).T product is "
            f"not measured (floats.DOT_CHAINS: K <= 64, every N <= "
            f"{DOT_MEASURED_N}, N <= {DOT_SAMPLED_N} where the counts "
            f"repeat; tests/measure_dot_chains.py measures more)")
    if k < u:
        u = 1
    full = k // u * u

    def product(j):
        return a[:, j:j + 1] * b[:, j][None, :]

    chains = []
    for j in range(u):
        acc = product(j)
        for jj in range(j + u, full, u):
            acc = fma(a[:, jj:jj + 1].expand(m, n),
                      b[:, jj][None, :].expand(m, n), acc)
        chains.append(acc)
    while len(chains) > 1:
        chains = [chains[i] + chains[i + 1]
                  for i in range(0, len(chains), 2)]
    out = chains[0]
    if full < k:
        tail = product(full)
        for j in range(full + 1, k):
            tail = tail + product(j)
        out = out + tail
    return out


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """float32 ``x ** y`` as XLA CPU computes it: its compiled code calls
    the C library's ``powf``, so this calls the same function, on the host,
    element by element (meant for small tables), and returns the result on
    ``x``'s device."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    y32 = float(np.float32(y))
    host = x.detach().to("cpu", torch.float32).reshape(-1).tolist()
    out = torch.tensor([libm.powf(v, y32) for v in host],
                       dtype=torch.float32)
    return out.reshape(x.shape).to(x.device)
