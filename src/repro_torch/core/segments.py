"""Canonical blocked reduction (port of ``repro.core.segments:122-184``).

The Algorithm-2 rounds' two reductions (remaining rate, block spend) go
through a fixed (REDUCE_BLOCKS, C) grid of per-block partials, each block
accumulated in event order, then folded over the block axis in order
``g = 0 .. REDUCE_BLOCKS-1`` by :func:`fold_blocks`. That fold is the one
XLA performs for ``parts.sum(axis=0)`` on the CPU (``torch.sum`` folds in
another order), so a port that reduces through here matches ``repro`` bit
for bit. ``aggregate`` and ``first_crossing_times`` arrive with the
SORT2AGGREGATE slice.
"""
from __future__ import annotations

import torch

REDUCE_BLOCKS = 32


def reduce_block_size(n_events: int) -> int:
    """Events per canonical reduction block (ceil so any N is covered)."""
    return -(-n_events // REDUCE_BLOCKS)


def partial_spend_sums(winners: torch.Tensor, prices: torch.Tensor,
                       num_campaigns: int,
                       weights: torch.Tensor | None = None, *,
                       block_size: int, index_offset=0) -> torch.Tensor:
    """(REDUCE_BLOCKS, C) per-canonical-block per-campaign partial spends.

    ``index_offset`` is the global event index of ``winners[0]``: a slice
    of the log lands in the same canonical blocks as in a whole-log
    reduction. Blocks outside the slice stay exactly 0.0.
    """
    p = prices if weights is None else prices * weights
    w = torch.where(winners < 0, num_campaigns, winners).long()
    idx = torch.arange(winners.shape[0], device=winners.device)
    blk = (index_offset + idx) // block_size
    ids = blk * (num_campaigns + 1) + w
    parts = torch.zeros(REDUCE_BLOCKS * (num_campaigns + 1), dtype=p.dtype,
                        device=p.device).index_add_(0, ids, p)
    return parts.reshape(REDUCE_BLOCKS, num_campaigns + 1)[:, :num_campaigns]


def fold_blocks(parts: torch.Tensor) -> torch.Tensor:
    """Sum the block axis (second to last) of ``(..., G, C)`` partials in
    order g = 0, 1, ..., G-1 — the canonical final reduce."""
    acc = parts[..., 0, :]
    for g in range(1, parts.shape[-2]):
        acc = acc + parts[..., g, :]
    return acc


def rate_from_events(winners: torch.Tensor, prices: torch.Tensor,
                     num_campaigns: int, start) -> torch.Tensor:
    """Mean per-campaign spend speed of resolved events with index >=
    ``start``: canonical partials, then the in-order fold."""
    n_events = winners.shape[0]
    idx = torch.arange(n_events, device=winners.device)
    weight = (idx >= start).to(prices.dtype)
    parts = partial_spend_sums(winners, prices, num_campaigns, weight,
                               block_size=reduce_block_size(n_events))
    sums = fold_blocks(parts)
    denom = torch.clamp(torch.as_tensor(n_events - start), min=1)
    return sums / denom.to(sums.dtype)


def block_from_events(winners: torch.Tensor, prices: torch.Tensor,
                      num_campaigns: int, lo, hi) -> torch.Tensor:
    """Per-campaign spend of resolved events in the half-open block
    ``[lo, hi)``, by the same canonical blocked arithmetic."""
    n_events = winners.shape[0]
    idx = torch.arange(n_events, device=winners.device)
    weight = ((idx >= lo) & (idx < hi)).to(prices.dtype)
    parts = partial_spend_sums(winners, prices, num_campaigns, weight,
                               block_size=reduce_block_size(n_events))
    return fold_blocks(parts)

