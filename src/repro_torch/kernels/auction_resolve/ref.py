"""Plain PyTorch versions of the fused-round kernels (port of
``repro.kernels.auction_resolve.ref:62,125,158``).

These are what the CUDA kernels in ``csrc/round_fused.cu`` compute, written
as ordinary tensor code: the CPU path runs them, and ``chip_smoke.py`` holds
the kernels against them on the card. The partials go through the same
event-ordered ``index_add_`` and the same in-order block fold as
:mod:`repro_torch.core.segments`; the prediction repeats
``repro_torch.core.executor.lane_predict``'s arithmetic vectorised over
lanes (kept here so the kernel package does not import the executor).
"""
from __future__ import annotations

import torch

from repro_torch.core.segments import REDUCE_BLOCKS, fold_blocks

NEG = -2.0 ** 30


def resolve_tile_ref(values: torch.Tensor, multipliers: torch.Tensor,
                     active: torch.Tensor, reserve,
                     second_price: bool = False):
    """Single-scenario resolve of a (T, C) valuation tile under a (C,) or
    (T, C) activation. Returns (winners (T,) int32 [-1 = no sale], prices
    (T,) float32, spend sums (C,))."""
    c = values.shape[1]
    bids = values.to(torch.float32) * multipliers.to(torch.float32)
    eligible = active & (bids > reserve)
    masked = torch.where(eligible, bids, NEG)
    winners = torch.argmax(masked, dim=1, keepdim=True)
    top = masked.gather(1, winners)[:, 0]
    sale = top > NEG
    if second_price:
        second = masked.scatter(1, winners, NEG).amax(1)
        prices = torch.where(
            sale, torch.maximum(torch.where(second > NEG, second, reserve),
                                torch.as_tensor(reserve)), 0.0)
    else:
        prices = torch.where(sale, top, 0.0)
    winners = torch.where(sale, winners[:, 0].to(torch.int32), -1)
    cols = torch.arange(c, device=values.device)
    sums = ((winners[:, None] == cols) * prices[:, None]).sum(0)
    return winners, prices.to(torch.float32), sums


def fused_partials_ref(values: torch.Tensor, multipliers: torch.Tensor,
                       active: torch.Tensor, reserves: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor, *,
                       block_size: int, reduce_blocks: int = REDUCE_BLOCKS,
                       second_price: bool = False,
                       index_offset: int = 0) -> torch.Tensor:
    """(S, G, C) canonical-block partial spends of the events in each
    lane's global window ``[lo[s], hi[s])``; ``values[0]`` is global event
    ``index_offset``. One lane at a time, so the peak is O(N·C)."""
    n_local, c = values.shape
    gidx = index_offset + torch.arange(n_local, device=values.device)
    ids_blk = (gidx // block_size) * (c + 1)
    out = []
    for s in range(multipliers.shape[0]):
        winners, prices, _ = resolve_tile_ref(
            values, multipliers[s], active[s], reserves[s],
            second_price=second_price)
        weight = ((gidx >= lo[s]) & (gidx < hi[s])).to(prices.dtype)
        w = torch.where(winners < 0, c, winners).long()
        parts = torch.zeros(reduce_blocks * (c + 1), dtype=torch.float32,
                            device=values.device)
        parts.index_add_(0, ids_blk + w, prices * weight)
        out.append(parts.reshape(reduce_blocks, c + 1)[:, :c])
    return torch.stack(out)


def predict_ref(rate_parts: torch.Tensor, budgets: torch.Tensor,
                s_hat: torch.Tensor, active: torch.Tensor,
                n_hat: torch.Tensor, *, n_events: int):
    """The per-lane cap-out prediction from (S, G, C) rate partials:
    ``(c_next (S,) int32, no_cap (S,) bool, n_next (S,) int32)``."""
    denom = torch.clamp(n_events - n_hat, min=1).to(torch.float32)
    rates = fold_blocks(rate_parts) / denom[:, None]
    ttl = torch.where(active & (rates > 0),
                      (budgets.to(torch.float32) - s_hat) / rates,
                      float("inf"))
    ttl = torch.where(ttl < 0, 0.0, ttl)
    c_next = torch.argmin(ttl, dim=1, keepdim=True)
    ttl_min = ttl.gather(1, c_next)[:, 0]
    no_cap = torch.isinf(ttl_min)
    step = torch.clamp(torch.floor(ttl_min), max=float(n_events))
    n_next = torch.where(no_cap, n_events,
                         torch.clamp(n_hat + step.to(torch.int32),
                                     max=n_events))
    return c_next[:, 0].to(torch.int32), no_cap, n_next.to(torch.int32)


def round_fused_ref(values: torch.Tensor, multipliers: torch.Tensor,
                    active: torch.Tensor, reserves: torch.Tensor,
                    budgets: torch.Tensor, s_hat: torch.Tensor,
                    n_hat: torch.Tensor, *, block_size: int,
                    reduce_blocks: int = REDUCE_BLOCKS,
                    second_price: bool = False):
    """One fused Algorithm-2 round: rate partials over ``[n_hat, N)``, the
    cap-out prediction, block partials over ``[n_hat, n_next)``. Returns
    ``(rate_parts (S, G, C), block_parts (S, G, C), c_next (S,),
    no_cap (S,), n_next (S,))``."""
    n_events = values.shape[0]
    n_hat = n_hat.to(torch.int32)
    kw = dict(block_size=block_size, reduce_blocks=reduce_blocks,
              second_price=second_price)
    rate_parts = fused_partials_ref(values, multipliers, active, reserves,
                                    n_hat, torch.full_like(n_hat, n_events),
                                    **kw)
    c_next, no_cap, n_next = predict_ref(rate_parts, budgets, s_hat, active,
                                         n_hat, n_events=n_events)
    block_parts = fused_partials_ref(values, multipliers, active, reserves,
                                     n_hat, n_next, **kw)
    return rate_parts, block_parts, c_next, no_cap, n_next
