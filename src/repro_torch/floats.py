"""Float32 arithmetic that rounds where the reference's compiled code does.

XLA's CPU backend contracts a float32 ``a * b + c`` inside one fused loop
into a fused multiply-add, which rounds once. Where ``repro`` computes such
an expression (Algorithm 4's step and update, ``jax.random.uniform``'s
scale and shift), the port must round once too, or a last bit differs and
the estimate drifts. PyTorch has no elementwise fused multiply-add, so
:func:`fma` computes it exactly in float64 with round-to-odd, which makes
the final rounding to float32 the correctly rounded one. The operands are
elementwise, so CPU and CUDA tensors give the same bits.
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
