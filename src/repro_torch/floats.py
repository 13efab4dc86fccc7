"""Float32 arithmetic that rounds where the reference's compiled code does.

XLA's CPU backend contracts a float32 ``a * b + c`` inside one fused loop
into a fused multiply-add, which rounds once. Where ``repro`` computes such
an expression (Algorithm 4's step and update, ``jax.random.uniform``'s
scale and shift), the port must round once too, or a last bit differs and
the estimate drifts. PyTorch has no elementwise fused multiply-add, so
:func:`fma` computes it exactly in float64 with round-to-odd, which makes
the final rounding to float32 the correctly rounded one. The operands are
elementwise, so CPU and CUDA tensors give the same bits.

XLA's CPU backend also brings its own float32 ``log1p`` and ``exp``: Cephes
polynomials in which the compiler contracts each multiply-add it can into
a fused one. :func:`log1p` and :func:`exp` repeat them operation for
operation from ``+ - * /``, :func:`fma`, ``floor``, compares and selects,
all IEEE on both devices, so they give ``jnp.log1p``'s and ``jnp.exp``'s
bits where ``torch.log1p`` and ``torch.exp`` differ in the last bit
(18% and 9.6% of float32 inputs). ``jax.random.normal`` and the bid noise
of the scenario families reach them through :mod:`repro_torch.prng` and
:mod:`repro_torch.core.crn`.
"""
from __future__ import annotations

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


def _log(x1: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log`` of ``x1``: the exponent split off, the
    mantissa moved into [sqrt(1/2), sqrt(2)), Cephes' polynomial."""
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
    (:func:`_log`) where ``|x| >= sqrt(2) - 1``, else Cephes' rational
    approximation ``x - x^2/2 + x^3 P(x)/Q(x)``."""
    x = x.to(torch.float32)
    large = _log(x + 1.0)
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
