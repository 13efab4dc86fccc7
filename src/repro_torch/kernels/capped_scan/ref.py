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


def _float32(scale: float) -> torch.Tensor | None:
    """The float32 scale of a sale's spend increment; None for 1 (the
    exact replay adds the price itself)."""
    r = torch.tensor(scale, dtype=torch.float32)
    if not bool((r > 0) & torch.isfinite(r)):
        raise ValueError(f"the scale must be finite and > 0, got {scale}")
    return None if bool(r == 1) else r


def capped_scan_ref(values: torch.Tensor, budgets: torch.Tensor,
                    multipliers: torch.Tensor, reserves: torch.Tensor,
                    second_price: bool = False, scale: float = 1.0):
    """S exact replays of ``values`` (N, C) under budgets and multipliers
    (S, C) and reserves (S,). Returns ``(winners (S, N) int32 [-1 = no
    sale], prices (S, N) float32, final spend (S, C) float32, cap times
    (S, C) int32)``; a cap time is 1-based, N+1 = never. A ``scale``
    other than 1 adds ``price * scale`` (float32) to the spend."""
    n, c = values.shape
    s_count = budgets.shape[0]
    dev = values.device
    sentinel = n + 1
    b = budgets.to(torch.float32)
    mult = multipliers.to(torch.float32)
    res = reserves.to(torch.float32).reshape(s_count, 1)
    r = _float32(scale)
    r = None if r is None else r.to(dev)
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
        spend.scatter_add_(1, w, (price if r is None else price * r)[:, None])
        cap.masked_fill_((spend >= b) & (cap == sentinel), i + 1)
        winners[:, i] = torch.where(sale, w[:, 0].to(torch.int32), -1)
        prices[:, i] = price
    return winners, prices, spend, cap


def _resolve_rows(rows: torch.Tensor, mult: torch.Tensor,
                  active: torch.Tensor, reserve: torch.Tensor,
                  second_price: bool):
    """One lane's rows (W, C) resolved against one frozen (C,) activation,
    with the per-event arithmetic of :func:`capped_scan_ref`."""
    bids = rows.to(torch.float32) * mult
    masked = torch.where(active & (bids > reserve), bids, NEG_INF)
    w = torch.argmax(masked, dim=1, keepdim=True)
    top = masked.gather(1, w)[:, 0]
    sale = top > NEG_INF
    if second_price:
        second = masked.scatter(1, w, NEG_INF).amax(1)
        second = torch.where(second > NEG_INF, second, reserve)
        price = torch.where(sale, torch.maximum(second, reserve), 0.0)
    else:
        price = torch.where(sale, top, 0.0)
    return torch.where(sale, w[:, 0].to(torch.int32), -1), price


def capped_scan_windows_ref(values: torch.Tensor, budgets: torch.Tensor,
                            multipliers: torch.Tensor,
                            reserves: torch.Tensor,
                            second_price: bool = False, *, window: int,
                            scale: float = 1.0):
    """:func:`capped_scan_ref` by the decomposition ``csrc/capped_scan.cu``
    runs, for tests: speculative windows against a frozen active set,
    repaired at the first cap.

    The active set ``spend < budget`` changes only when a sale leaves its
    campaign at or above its budget. So a lane resolves the ``window``
    events from ``n0`` all against the active set at ``n0``, then adds each
    campaign's sales to its spend in event order and finds the first event
    ``k`` after which a spend is no longer below its budget. Events ``[n0,
    k]`` are exactly the sequential replay's; the lane commits them (the
    whole window if nothing capped), sets the cap time ``k + 1`` and
    restarts at ``k + 1``. A budget <= 0 caps at event 1, unsold. A
    ``scale`` other than 1 adds ``price * scale`` (float32), as the
    kernel's scaled walk does."""
    n, c = values.shape
    s_count = budgets.shape[0]
    dev = values.device
    b = budgets.to(torch.float32)
    mult = multipliers.to(torch.float32)
    res = reserves.to(torch.float32)
    factor = _float32(scale)
    winners = torch.empty((s_count, n), dtype=torch.int32, device=dev)
    prices = torch.empty((s_count, n), dtype=torch.float32, device=dev)
    spend = torch.zeros((s_count, c), dtype=torch.float32, device=dev)
    cap = torch.where(0.0 >= b, 1, n + 1).to(torch.int32)
    for lane in range(s_count):
        sp, bl = spend[lane], b[lane]
        n0 = 0
        while n0 < n:
            hi = min(n0 + window, n)
            w, p = _resolve_rows(values[n0:hi], mult[lane], sp < bl,
                                 res[lane], second_price)
            k = hi - n0 - 1                       # commit the whole window
            trial = sp.clone()
            for r, wr in enumerate(w.tolist()):   # the ordered sums
                if wr < 0:
                    continue
                trial[wr] += p[r] if factor is None else p[r] * factor
                if not bool(trial[wr] < bl[wr]):
                    k = r
                    if bool(trial[wr] >= bl[wr]):
                        cap[lane, wr] = n0 + r + 1
                    break
            sp.copy_(trial)
            winners[lane, n0:n0 + k + 1] = w[:k + 1]
            prices[lane, n0:n0 + k + 1] = p[:k + 1]
            n0 += k + 1
    return winners, prices, spend, cap
