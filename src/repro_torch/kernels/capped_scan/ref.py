"""Plain PyTorch version of the capped-scan kernel (port of
``repro.kernels.capped_scan.ref:11``), batched over scenario lanes.

The exact serial replay of the burnout dynamics (Eqs. 1-3) for S lanes at
once: a Python loop over the events, each a few tensor ops on (S, C) state
with no host sync. Each spend takes one float32 add per sale, as the
reference's ``s.at[w].add(p)`` does. It is what ``csrc/capped_scan.cu``
computes; the CPU path runs it, and ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = float("-inf")


def capped_scan_ref(values: torch.Tensor, budgets: torch.Tensor,
                    multipliers: torch.Tensor, reserves: torch.Tensor,
                    second_price: bool = False):
    """S exact replays of ``values`` (N, C) under budgets and multipliers
    (S, C) and reserves (S,). Returns ``(winners (S, N) int32 [-1 = no
    sale], prices (S, N) float32, final spend (S, C) float32, cap times
    (S, C) int32)``; a cap time is 1-based, N+1 = never."""
    n, c = values.shape
    s_count = budgets.shape[0]
    dev = values.device
    sentinel = n + 1
    b = budgets.to(torch.float32)
    mult = multipliers.to(torch.float32)
    res = reserves.to(torch.float32).reshape(s_count, 1)
    spend = torch.zeros((s_count, c), dtype=torch.float32, device=dev)
    cap = torch.full((s_count, c), sentinel, dtype=torch.int32, device=dev)
    winners = torch.empty((s_count, n), dtype=torch.int32, device=dev)
    prices = torch.empty((s_count, n), dtype=torch.float32, device=dev)
    for i in range(n):
        bids = values[i].to(torch.float32) * mult
        masked = torch.where((spend < b) & (bids > res), bids, NEG_INF)
        w = torch.argmax(masked, dim=1, keepdim=True)
        top = masked.gather(1, w)[:, 0]
        sale = top > NEG_INF
        if second_price:
            second = masked.scatter(1, w, NEG_INF).amax(1)
            second = torch.where(second > NEG_INF, second, res[:, 0])
            price = torch.where(sale, torch.maximum(second, res[:, 0]), 0.0)
        else:
            price = torch.where(sale, top, 0.0)
        # one add per lane; no sale adds +0.0 to the argmax column, an
        # exact no-op
        spend.scatter_add_(1, w, price[:, None])
        cap.masked_fill_((spend >= b) & (cap == sentinel), i + 1)
        winners[:, i] = torch.where(sale, w[:, 0].to(torch.int32), -1)
        prices[:, i] = price
    return winners, prices, spend, cap
