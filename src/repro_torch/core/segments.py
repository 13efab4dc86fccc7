"""Canonical blocked reduction (port of ``repro.core.segments:122-215``).

The Algorithm-2 rounds' two reductions (remaining rate, block spend) go
through a fixed (REDUCE_BLOCKS, C) grid of per-block partials, each block
accumulated in event order, then folded over the block axis in order
``g = 0 .. REDUCE_BLOCKS-1`` by :func:`fold_blocks`. That fold is the one
XLA performs for ``parts.sum(axis=0)`` on the CPU (``torch.sum`` folds in
another order), so a port that reduces through here matches ``repro`` bit
for bit.

The partials dispatch on the device. On the CPU, ``index_add_`` adds in
event order, as XLA's segment sum does (:func:`index_add_partials`, the
plain version). On CUDA, ``index_add_`` adds with atomics in an order that
changes from run to run, and one last-bit difference moves Algorithm 2 onto
another trajectory; so CUDA tensors go to the event-ordered kernel of
``csrc/segment_partials.cu``, which gives the CPU's bits.
``aggregate`` and ``first_crossing_times`` arrive with the SORT2AGGREGATE
slice.
"""
from __future__ import annotations

import torch

from repro_torch.core import auction
from repro_torch.kernels.auction_resolve.segment_partials import \
    segment_partials_cuda

REDUCE_BLOCKS = 32


def reduce_block_size(n_events: int) -> int:
    """Events per canonical reduction block (ceil so any N is covered)."""
    return -(-n_events // REDUCE_BLOCKS)


def index_add_partials(winners: torch.Tensor, p: torch.Tensor,
                       num_campaigns: int, *, block_size: int,
                       index_offset=0) -> torch.Tensor:
    """The plain version: (REDUCE_BLOCKS, C) partials of the (already
    weighted) prices ``p`` by one ``index_add_`` — in event order on the
    CPU, with atomics on CUDA."""
    w = torch.where(winners < 0, num_campaigns, winners).long()
    idx = torch.arange(winners.shape[0], device=winners.device)
    blk = (index_offset + idx) // block_size
    ids = blk * (num_campaigns + 1) + w
    parts = torch.zeros(REDUCE_BLOCKS * (num_campaigns + 1), dtype=p.dtype,
                        device=p.device).index_add_(0, ids, p)
    return parts.reshape(REDUCE_BLOCKS, num_campaigns + 1)[:, :num_campaigns]


def _i32(x, n: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device).expand(
        n).contiguous()


def partial_spend_sums(winners: torch.Tensor, prices: torch.Tensor,
                       num_campaigns: int,
                       weights: torch.Tensor | None = None, *,
                       block_size: int, index_offset=0) -> torch.Tensor:
    """(REDUCE_BLOCKS, C) per-canonical-block per-campaign partial spends,
    each added in event order: :func:`index_add_partials` on the CPU, the
    ``segment_partials`` kernel on CUDA.

    ``index_offset`` is the global event index of ``winners[0]``: a slice
    of the log lands in the same canonical blocks as in a whole-log
    reduction. Blocks outside the slice stay exactly 0.0.
    """
    p = prices if weights is None else prices * weights
    if winners.device.type == "cpu":
        return index_add_partials(winners, p, num_campaigns,
                                  block_size=block_size,
                                  index_offset=index_offset)
    offset = int(index_offset)
    return window_partials(winners[None], p[None], num_campaigns, offset,
                           offset + winners.shape[0], block_size=block_size,
                           index_offset=offset)[0]


def window_partials_ref(winners: torch.Tensor, prices: torch.Tensor,
                        num_campaigns: int, lo, hi, *, block_size: int,
                        index_offset: int = 0) -> torch.Tensor:
    """The plain version of :func:`window_partials`: each lane's prices
    weighted by its window, then :func:`index_add_partials`."""
    s, n = winners.shape
    gidx = index_offset + torch.arange(n, device=winners.device)
    lo, hi = _i32(lo, s, winners.device), _i32(hi, s, winners.device)
    return torch.stack([
        index_add_partials(
            winners[k], prices[k] * ((gidx >= lo[k]) & (gidx < hi[k])).to(
                prices.dtype), num_campaigns, block_size=block_size,
            index_offset=index_offset)
        for k in range(s)])


def window_partials(winners: torch.Tensor, prices: torch.Tensor,
                    num_campaigns: int, lo, hi, *, block_size: int,
                    index_offset: int = 0) -> torch.Tensor:
    """(S, REDUCE_BLOCKS, C) partials of S lanes of resolved events
    (``winners``/``prices`` (S, n), global events ``[index_offset,
    index_offset + n)``), lane s taking the events in its window ``[lo[s],
    hi[s])``: :func:`partial_spend_sums` with a window weight, for all lanes
    at once — one kernel launch on CUDA."""
    if winners.device.type == "cpu":
        return window_partials_ref(winners, prices, num_campaigns, lo, hi,
                                   block_size=block_size,
                                   index_offset=index_offset)
    s = winners.shape[0]
    return segment_partials_cuda(
        winners.to(torch.int32).contiguous(),
        prices.to(torch.float32).contiguous(),
        _i32(lo, s, winners.device), _i32(hi, s, winners.device),
        num_campaigns=num_campaigns, block_size=block_size,
        reduce_blocks=REDUCE_BLOCKS, offset=index_offset)


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


def masked_rate(values: torch.Tensor, active: torch.Tensor, rule,
                start) -> torch.Tensor:
    """E[f(e, a)] over the events with index >= ``start`` under a fixed
    (C,) activation: resolve every event, then :func:`rate_from_events`."""
    winners, prices = auction.resolve(values, active, rule)
    return rate_from_events(winners, prices, values.shape[1], start)


def block_spend_sums(values: torch.Tensor, active: torch.Tensor, rule,
                     lo, hi) -> torch.Tensor:
    """Per-campaign spend over the events in ``[lo, hi)`` under a fixed
    (C,) activation (order-free): resolve, then :func:`block_from_events`."""
    winners, prices = auction.resolve(values, active, rule)
    return block_from_events(winners, prices, values.shape[1], lo, hi)
