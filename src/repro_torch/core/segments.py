"""Segment-indexed replay and the canonical blocked reduction (port of
``repro.core.segments``).

**Replay under a segment history** (SORT2AGGREGATE's passes).
:func:`aggregate` resolves every event under its segment's activation mask
and reads off the per-campaign totals and first budget crossings
(:func:`first_crossing_times`). Both sums follow ``repro``'s float order
exactly: the total is a flat per-campaign sum in event order (XLA's segment
sum on the CPU), and the crossing scan adds each block's one-hot spends in
the order of XLA's CPU ``cumsum`` (:func:`xla_cumsum`). On CUDA tensors
the resolve is the ``auction_resolve`` kernel and both sums come from one
``first_crossing`` kernel launch (``csrc/first_crossing.cu``), which gives
the CPU's bits.

**Canonical blocked reduction.** The Algorithm-2 rounds' two reductions (remaining rate, block spend) go
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
"""
from __future__ import annotations

import torch

from repro_torch.core import auction
from repro_torch.core.types import (AuctionRule, Segments, SimResult,
                                    never_capped)
from repro_torch.kernels.auction_resolve.first_crossing import \
    first_crossing_cuda
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


# ---------------------------------------------------------------------------
# Replay under a fixed segment history (SORT2AGGREGATE)
# ---------------------------------------------------------------------------

_GROUP = 16


def _sequential_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim -2, one float32 add per row in order
    (``torch.cumsum`` accumulates float32 in double on the CPU)."""
    out = torch.empty_like(x)
    acc = x[..., 0, :] + 0.0
    out[..., 0, :] = acc
    for j in range(1, x.shape[-2]):
        acc = acc + x[..., j, :]
        out[..., j, :] = acc
    return out


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of ``x`` (..., L, C) along its rows (dim -2),
    added in the order of ``jnp.cumsum`` on XLA's CPU backend.

    XLA lowers the cumsum to a ``reduce_window`` and rewrites it as a scan
    of groups of 16 rows, recursively:

    1. rows are grouped 16 at a time from row 0 (the last group padded
       with zeros); inside a group each row's prefix is a sequential sum,
       ``((0 + x[16k]) + x[16k+1]) + ...``;
    2. the group totals (the last prefix of each group) are scanned by the
       same rule, recursively;
    3. row i of group k gets ``scan(totals)[k-1] + prefix_i`` (group 0 gets
       ``0 + prefix_i``).

    A sequence of at most 16 rows is a plain sequential prefix. The order is
    neither sequential nor ``lax.associative_scan``'s, so a port must repeat
    it to find the same first budget crossing: one ulp moves a cap time, and
    SORT2AGGREGATE's refinement then moves the whole segment history. The
    value of row i depends only on rows <= i, so a ragged block needs no
    padding. Matched bit for bit against ``jnp.cumsum`` (jax 0.9.0, CPU) in
    ``tests/test_torch_s2a.py``.
    """
    n = x.shape[-2]
    if n <= _GROUP:
        return _sequential_prefix(x)
    groups = -(-n // _GROUP)
    pad = groups * _GROUP - n
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))],
                      dim=-2)
    grouped = _sequential_prefix(
        x.reshape(x.shape[:-2] + (groups, _GROUP, x.shape[-1])))
    scan = xla_cumsum(grouped[..., -1, :])
    exclusive = torch.cat([torch.zeros_like(scan[..., :1, :]),
                           scan[..., :-1, :]], dim=-2)
    out = exclusive[..., :, None, :] + grouped
    return out.reshape(x.shape)[..., :n, :]


def first_crossing_ref(winners: torch.Tensor, prices: torch.Tensor,
                       budgets: torch.Tensor, num_campaigns: int,
                       block: int = 4096) -> torch.Tensor:
    """The plain version of :func:`first_crossing_times`, for (N,) or
    (S, N) winners/prices and (C,) or (S, C) budgets: a loop over blocks of
    ``block`` events carrying the (C,) running total ``s0``; in each block
    ``cum = s0 + xla_cumsum(one-hot spends)`` and a campaign's cap time is
    the 1-based index of its first ``cum >= budget``, else N+1."""
    n = winners.shape[-1]
    sentinel = never_capped(n)
    lead = winners.shape[:-1]
    dev = winners.device
    b = budgets.to(torch.float32)[..., None, :]
    cols = torch.arange(num_campaigns, device=dev)
    s0 = torch.zeros(lead + (num_campaigns,), dtype=torch.float32,
                     device=dev)
    cap = torch.full(lead + (num_campaigns,), sentinel, dtype=torch.int32,
                     device=dev)
    for lo in range(0, n, block):
        w = winners[..., lo:lo + block, None]
        p = prices[..., lo:lo + block, None].to(torch.float32)
        cum = s0[..., None, :] + xla_cumsum((w == cols).to(p.dtype) * p)
        crossed = cum >= b
        first = torch.argmax(crossed.to(torch.uint8), dim=-2)
        hit = (cap == sentinel) & crossed.any(dim=-2)
        cap = torch.where(hit, (lo + first + 1).to(torch.int32), cap)
        s0 = cum[..., -1, :]
    return torch.clamp(cap, max=sentinel)


def first_crossing_times(winners: torch.Tensor, prices: torch.Tensor,
                         budgets: torch.Tensor, num_campaigns: int,
                         block: int = 4096) -> torch.Tensor:
    """1-based index at which each campaign's cumulative spend first
    reaches its budget; N+1 if it never does. Blockwise: each block of
    ``block`` events is scanned in XLA's cumsum order (:func:`xla_cumsum`)
    from the running total the previous blocks carried. (N,) or (S, N)
    winners/prices with (C,) or (S, C) budgets; one ``first_crossing``
    kernel launch for CUDA tensors, :func:`first_crossing_ref` for CPU
    tensors."""
    return crossing_and_spend(winners, prices, budgets, num_campaigns,
                              block)[1]


def crossing_and_spend(winners: torch.Tensor, prices: torch.Tensor,
                       budgets: torch.Tensor, num_campaigns: int,
                       block: int = 4096):
    """``(final spend, cap times)`` of resolved events: the flat
    per-campaign sums in event order (``repro``'s ``auction.spend_sums``)
    and :func:`first_crossing_times`. (N,) or (S, N) winners/prices give
    (C,) or (S, C) results. On CUDA both come from one ``first_crossing``
    launch; on the CPU from ``index_add_`` and :func:`first_crossing_ref`.
    """
    if winners.device.type == "cpu":
        return (auction.spend_sums(winners, prices, num_campaigns),
                first_crossing_ref(winners, prices, budgets, num_campaigns,
                                   block))
    lanes = winners.reshape(-1, winners.shape[-1])
    cap, spend = first_crossing_cuda(
        lanes.to(torch.int32).contiguous(),
        prices.reshape(lanes.shape).to(torch.float32).contiguous(),
        budgets.reshape(-1, num_campaigns).to(torch.float32).contiguous(),
        num_campaigns=num_campaigns, block=block)
    out = winners.shape[:-1] + (num_campaigns,)
    return spend.reshape(out), cap.reshape(out)


def resolve_segments(values: torch.Tensor, segments: Segments,
                     rule: AuctionRule):
    """(winners (N,), prices (N,)) of every event under its segment's
    activation mask: the (N, C) mask ``segments.masks[seg_ids]`` and one
    ``resolve_masked`` (the ``auction_resolve`` kernel on CUDA)."""
    # ops imports this module (REDUCE_BLOCKS), so it is imported here
    from repro_torch.kernels.auction_resolve import ops as resolve_ops
    n_events = values.shape[0]
    masks = segments.masks[segments.seg_ids(n_events)]
    winners, prices, _ = resolve_ops.resolve_masked(
        values, rule.multipliers, masks, rule.reserve,
        second_price=rule.kind == "second_price", sums=False)
    return winners, prices


def aggregate(values: torch.Tensor, segments: Segments,
              budgets: torch.Tensor, rule: AuctionRule,
              record_events: bool = True,
              crossing_block: int = 4096) -> SimResult:
    """Replay the whole log under a fixed segment history in one parallel
    pass: every event resolved under its segment's mask
    (:func:`resolve_segments`), the per-campaign totals and first budget
    crossings read off the replay (:func:`crossing_and_spend`). Cap times
    are diagnosed from the replay, not assumed: SORT2AGGREGATE's check
    between its refine and aggregate steps."""
    winners, prices = resolve_segments(values, segments, rule)
    final_spend, cap_times = crossing_and_spend(
        winners, prices, budgets, values.shape[1], crossing_block)
    return SimResult(
        final_spend=final_spend, cap_times=cap_times,
        winners=winners if record_events else None,
        prices=prices if record_events else None, segments=segments)
