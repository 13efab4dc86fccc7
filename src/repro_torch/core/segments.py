"""Segment-indexed replay and the canonical blocked reduction (port of
``repro.core.segments``).

**Replay under a segment history** (SORT2AGGREGATE's passes).
:func:`aggregate` resolves every event under its segment's activation mask
and reads off the per-campaign totals and first budget crossings
(:func:`first_crossing_times`). Both sums follow ``repro``'s float order
exactly: the total is a flat per-campaign sum in event order (XLA's segment
sum on the CPU), and the crossing scan adds each block's one-hot spends in
the order of XLA's CPU ``cumsum`` (:func:`xla_cumsum`). On CUDA tensors
the resolve is the ``segment_resolve`` kernel and both sums come from one
``first_crossing`` kernel call (``csrc/first_crossing.cu``), which gives
the CPU's bits; a call that needs the cap times only skips the flat sums.

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


def _crossing_scan(winners, prices, budgets, num_campaigns: int,
                   block: int, s0: torch.Tensor, cap: torch.Tensor,
                   offset: int, sentinel: int):
    """The blockwise crossing scan from the carry ``(s0, cap)``: the rows
    are global events ``[offset, offset + N)``. Returns the carry after the
    last row."""
    n = winners.shape[-1]
    b = budgets.to(torch.float32)[..., None, :]
    cols = torch.arange(num_campaigns, device=winners.device)
    for lo in range(0, n, block):
        w = winners[..., lo:lo + block, None]
        p = prices[..., lo:lo + block, None].to(torch.float32)
        cum = s0[..., None, :] + xla_cumsum((w == cols).to(p.dtype) * p)
        crossed = cum >= b
        first = torch.argmax(crossed.to(torch.uint8), dim=-2)
        hit = (cap == sentinel) & crossed.any(dim=-2)
        cap = torch.where(hit, (offset + lo + first + 1).to(torch.int32),
                          cap)
        s0 = cum[..., -1, :]
    return s0, cap


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
    shape = winners.shape[:-1] + (num_campaigns,)
    dev = winners.device
    _, cap = _crossing_scan(
        winners, prices, budgets, num_campaigns, block,
        torch.zeros(shape, dtype=torch.float32, device=dev),
        torch.full(shape, sentinel, dtype=torch.int32, device=dev), 0,
        sentinel)
    return torch.clamp(cap, max=sentinel)


def _check_carry(n: int, block: int, offset: int, n_global: int) -> None:
    if offset % block or not 0 <= offset <= n_global - n:
        raise ValueError(
            f"rows [{offset}, {offset + n}) of a log of {n_global} events "
            f"must start on a crossing block of {block}")


def crossing_carry(winners: torch.Tensor, prices: torch.Tensor,
                   budgets: torch.Tensor, num_campaigns: int, block: int, *,
                   s0: torch.Tensor, cap: torch.Tensor, offset: int,
                   n_global: int):
    """One chunk of the blockwise crossing scan: S lanes of resolved events
    (winners/prices (S, n)), global events ``[offset, offset + n)`` of a
    log of ``n_global``, ``offset`` a multiple of ``block``, from the
    running spend ``s0`` and cap times ``cap`` (S, C) the earlier rows left
    (sentinel ``n_global + 1``). Returns ``(s0, cap)`` after the last row:
    chained over the chunks of a log, the cap times of
    :func:`first_crossing_times` on the whole log and its running total.
    One caps-only ``first_crossing`` call on CUDA (no flat sums),
    :func:`_crossing_scan` on the CPU."""
    _check_carry(winners.shape[-1], block, offset, n_global)
    if winners.device.type == "cpu":
        return _crossing_scan(winners, prices, budgets, num_campaigns, block,
                              s0, cap, offset, never_capped(n_global))
    cap, _, s0 = first_crossing_cuda(
        winners.to(torch.int32).contiguous(),
        prices.to(torch.float32).contiguous(),
        budgets.to(torch.float32).contiguous(), num_campaigns=num_campaigns,
        block=block, carry=(s0.contiguous(), cap.contiguous(), offset,
                            n_global), spend=False)
    return s0, cap


def shard_crossing(winners: torch.Tensor, prices: torch.Tensor,
                   budgets: torch.Tensor, num_campaigns: int, *,
                   s0: torch.Tensor, cap: torch.Tensor, offset: int,
                   n_global: int):
    """One event shard's part of the sharded crossing diagnosis
    (``repro``'s ``_local_first_crossing``): S lanes of resolved events
    (winners/prices (S, n)), global events ``[offset, offset + n)`` of a
    log of ``n_global``, ``offset`` a multiple of ``n``, scanned as ONE
    block — ``s0 + cumsum`` over all n rows in XLA's order — from the
    prefix ``s0`` (S, C) of the shards before it; a campaign whose ``cap``
    is not the sentinel ``n_global + 1`` keeps it (the earlier shard's
    crossing, which ``repro``'s ``pmin`` picks). Returns ``(flat sums (S,
    C) of the shard's rows in event order, cap times (S, C))``: one
    ``first_crossing`` call with a carry on CUDA (``block = n``), the flat
    ``index_add_`` sums and :func:`_crossing_scan` on the CPU."""
    n = winners.shape[-1]
    _check_carry(n, n, offset, n_global)
    if winners.device.type == "cpu":
        _, cap = _crossing_scan(winners, prices, budgets, num_campaigns, n,
                                s0, cap, offset, never_capped(n_global))
        return auction.spend_sums(winners, prices, num_campaigns), cap
    cap, spend, _ = first_crossing_cuda(
        winners.to(torch.int32).contiguous(),
        prices.to(torch.float32).contiguous(),
        budgets.to(torch.float32).contiguous(), num_campaigns=num_campaigns,
        block=n, carry=(s0.contiguous(), cap.contiguous(), offset,
                        n_global))
    return spend, cap


_TILE = 4096          # rows of a crossing tile, 16^3: csrc/first_crossing.cu
_HI_MARGIN = 1.0 + 2.0 ** -12   # a tile's values lie below its last's times


def _group_prefix(x: torch.Tensor) -> torch.Tensor:
    """In-group sequential prefixes of ``x`` (..., L, C) along its rows, in
    groups of 16 from row 0 (the last group padded with zeros): (..., G, 16,
    C), row ``i`` at ``[..., i // 16, i % 16, :]``."""
    n = x.shape[-2]
    groups = -(-n // _GROUP)
    pad = groups * _GROUP - n
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))],
                      dim=-2)
    return _sequential_prefix(
        x.reshape(x.shape[:-2] + (groups, _GROUP, x.shape[-1])))


def _tile_levels(sm: torch.Tensor):
    """A tile's in-group prefixes (S, rows, C) -> ``(P_0, P_1, P_2)``, each
    flattened to (S, entries, C): P_0 over the rows, P_1 over the 16-row
    groups' totals, P_2 over the level-1 groups' totals (one group: a tile
    holds at most 16 of them)."""
    def flat(p):
        return p.reshape(p.shape[0], -1, p.shape[-1])
    p0 = _group_prefix(sm)
    p1 = _group_prefix(p0[:, :, -1, :])
    p2 = _group_prefix(p1[:, :, -1, :])
    return flat(p0), flat(p1), flat(p2)


def _tile_tested(w: torch.Tensor, cols: torch.Tensor):
    """The rows of a tile at which the kernel's pass C tests a campaign
    (S, rows, C): its sales, and the first rows of the 16-row groups where
    the exclusive prefix may move: the first two groups of each level-1
    group (256 rows) and the group after a group with a sale."""
    sale = w[:, :, None] == cols
    rows = sale.shape[1]
    groups = -(-rows // _GROUP)
    pad = groups * _GROUP - rows
    sale_g = torch.nn.functional.pad(sale, (0, 0, 0, pad)).reshape(
        sale.shape[0], groups, _GROUP, -1).any(dim=2)
    a = torch.arange(groups, device=w.device)
    cand = (a % _GROUP <= 1)[None, :, None].expand(sale_g.shape).clone()
    cand[:, 1:] |= sale_g[:, :-1]
    start = torch.zeros(rows, dtype=torch.bool, device=w.device)
    start[::_GROUP] = True
    return sale | (start[None, :, None] & cand[:, torch.arange(
        rows, device=w.device) // _GROUP])


def first_crossing_blocks_ref(winners: torch.Tensor, prices: torch.Tensor,
                              budgets: torch.Tensor, num_campaigns: int,
                              block: int = 4096, *, s0=None, cap=None,
                              offset: int = 0, n_global: int | None = None,
                              spend: bool = True):
    """``(spend, cap times, running spend after the last row)`` of S lanes
    (``winners``/``prices`` (S, N), ``budgets`` (S, C)) by the
    decomposition ``csrc/first_crossing.cu`` runs; for tests, bitwise
    :func:`first_crossing_ref`, :func:`crossing_carry` and the flat sums.
    ``spend=False`` (the kernel's caps-only mode) returns None for the
    spends.

    Every crossing block is cut into tiles of 4,096 rows from its first
    row (a block of at most 4,096 rows is one tile).

    * Pass A: each tile's in-group prefixes at its last row ``i``: ``c0 =
      P_0[i]``, ``c1 = P_1[(i >> 4) - 1]``, ``c2 = P_2[((i >> 4) - 1 >> 4)
      - 1]`` (0.0 where an index is negative).
    * Pass B, per block: a whole tile's total ``tot = c2 + (c1 + c0)``;
      the exclusive prefixes ``E`` of the tiles, XLA's scan of the totals
      (:func:`xla_cumsum`); each tile's start state ``(st0, st1, st2)``, 0
      for the first and ``((E' + c2') + (c1' + c0'), E' + tot', E)`` after
      a whole tile (primes: the tile before); the value at the block's
      last row ``((st2 + c2) + c1) + c0`` (``(st1 + c1) + c0`` when ``(i
      >> 4) - 1 < 16``, ``st0 + c0`` when ``i < 16``); the chain ``s0[b+1]
      = s0[b] + last[b]`` from 0.0 or the carried ``s0``.
    * Pass C: the value of row ``r`` of group ``a``, ``E0(a) + P_0[r]``
      with ``E0(0) = st0``, ``E0(a) = E1((a-1) >> 4) + P_1[a-1]``, ``E1(0)
      = st1``, ``E1(y) = st2 + P_2[y-1]`` (``E0(16 y) = E1(y-1) +
      V2[y-1]``, ``V2`` a level-1 group's total); ``s0 + value >= budget``
      tested at the campaign's sales and at the group starts where ``E0``
      may move (:func:`_tile_tested`). A campaign is not walked where ``s0 + st0 >=
      budget`` (the tile's first row crosses) or ``s0 + hi < budget``, ``hi``
      the tile's last value times ``1 + 2^-12`` (no row can: every value of
      the tile lies below it while no price of the block so far is
      negative; NaN, and every campaign walked, after one). The earliest
      crossing wins, at global time ``offset + row + 1``; a campaign whose
      carried ``cap`` is not the sentinel ``n_global + 1`` keeps it.
    * Flat sums: a stable sort of each lane's events by winner, then one
      chain per (lane, campaign) over its own sales in event order, from
      0.0 (a non-sale adds +0.0, which changes nothing).
    """
    s, n = winners.shape
    c = num_campaigns
    dev = winners.device
    n_global = n if n_global is None else n_global
    _check_carry(n, block, offset, n_global)
    sentinel = never_capped(n_global)
    cols = torch.arange(c, device=dev)
    b = budgets.to(torch.float32)[:, None, :]
    p32 = prices.to(torch.float32)
    run = (torch.zeros((s, c), dtype=torch.float32, device=dev)
           if s0 is None else s0)
    found = torch.full((s, c), sentinel, dtype=torch.int32, device=dev)
    zero = torch.zeros((s, c), dtype=torch.float32, device=dev)
    for lo in range(0, n, block):
        length = min(block, n - lo)
        tiles, sums = [], []
        for t0 in range(lo, lo + length, _TILE):               # pass A
            rows = min(_TILE, lo + length - t0)
            w = winners[:, t0:t0 + rows]
            sm = (w[:, :, None] == cols).to(torch.float32) \
                * p32[:, t0:t0 + rows, None]
            p0, p1, p2 = _tile_levels(sm)
            ai = (rows - 1) >> 4
            y = (ai - 1) >> 4
            cs = (p0[:, rows - 1], p1[:, ai - 1] if ai > 0 else zero,
                  p2[:, y - 1] if ai > 0 and y > 0 else zero)
            tiles.append((t0, rows, w, p0, p1, p2))
            sums.append(cs)
        # pass B: the tiles' start states, the last value, the s0 chain
        tots = [c2 + (c1 + c0) for c0, c1, c2 in sums[:-1]]
        scan = xla_cumsum(torch.stack(tots, dim=1)) if tots else None
        starts = [(zero, zero, zero)]
        for j in range(1, len(sums)):
            e_prev = zero if j == 1 else scan[:, j - 2]
            c0, c1, c2 = sums[j - 1]
            starts.append(((e_prev + c2) + (c1 + c0), e_prev + tots[j - 1],
                           scan[:, j - 1]))
        lasts, neg = [], torch.zeros(s, dtype=torch.bool, device=dev)
        for (t0, rows, *_), (st0, st1, st2), (c0, c1, c2) in zip(
                tiles, starts, sums):       # the value at each last row
            ai = (rows - 1) >> 4
            lasts.append(st0 + c0 if ai == 0 else (st1 + c1) + c0
                         if (ai - 1) >> 4 == 0 else ((st2 + c2) + c1) + c0)
        last = lasts[-1]
        for (t0, rows, w, p0, p1, p2), (st0, st1, st2), tile_last in zip(
                tiles, starts, lasts):                          # pass C
            # campaigns whose first row crosses, and those no row of the
            # tile can reach: the bound is NaN after a negative price
            neg |= (p32[:, t0:t0 + rows] < 0).any(dim=1)
            hi = torch.where(neg[:, None], torch.nan,
                             tile_last * _HI_MARGIN)
            at_start = (hi == hi) & (run + st0 >= b[:, 0])
            walk = ~at_start & ~(run + hi < b[:, 0])
            found = torch.where(at_start & (found == sentinel),
                                offset + t0 + 1, found)
            groups = -(-rows // _GROUP)
            lvl1 = -(-groups // _GROUP)
            e1 = torch.cat([st1[:, None], st2[:, None] + p2[:, :lvl1 - 1]],
                           dim=1)
            a = torch.arange(1, groups, device=dev)
            e0 = torch.cat([st0[:, None],
                            e1[:, (a - 1) // _GROUP] + p1[:, a - 1]], dim=1)
            r = torch.arange(rows, device=dev)
            value = e0[:, r // _GROUP] + p0[:, :rows]
            crossed = ((run[:, None, :] + value) >= b) & _tile_tested(
                w, cols) & walk[:, None, :]
            first = torch.argmax(crossed.to(torch.uint8), dim=1)
            hit = crossed.any(dim=1) & (found == sentinel)
            found = torch.where(hit, (offset + t0 + first + 1).to(
                torch.int32), found)
        run = run + last
    cap = found if cap is None else torch.where(cap != sentinel, cap, found)
    if not spend:
        return None, cap, run
    # flat sums: the counting sort and the per-campaign chains
    key = torch.where(winners < 0, c, winners).long()
    order = torch.argsort(key, dim=1, stable=True)
    sorted_p = p32.gather(1, order)
    counts = torch.zeros((s, c + 1), dtype=torch.long, device=dev)
    counts.scatter_add_(1, key, torch.ones_like(key))
    first_pos = torch.cumsum(counts, dim=1) - counts
    sums = torch.zeros((s, c), dtype=torch.float32, device=dev)
    longest = int(counts[:, :c].max()) if n else 0
    for i in range(longest):
        live = i < counts[:, :c]
        pos = torch.clamp(first_pos[:, :c] + i, max=max(n - 1, 0))
        sums = torch.where(live, sums + sorted_p.gather(1, pos), sums)
    return sums, cap, run


def first_crossing_times(winners: torch.Tensor, prices: torch.Tensor,
                         budgets: torch.Tensor, num_campaigns: int,
                         block: int = 4096) -> torch.Tensor:
    """1-based index at which each campaign's cumulative spend first
    reaches its budget; N+1 if it never does. Blockwise: each block of
    ``block`` events is scanned in XLA's cumsum order (:func:`xla_cumsum`)
    from the running total the previous blocks carried. (N,) or (S, N)
    winners/prices with (C,) or (S, C) budgets; one caps-only
    ``first_crossing`` call for CUDA tensors (no flat sums),
    :func:`first_crossing_ref` for CPU tensors."""
    if winners.device.type == "cpu":
        return first_crossing_ref(winners, prices, budgets, num_campaigns,
                                  block)
    lanes = winners.reshape(-1, winners.shape[-1])
    cap, _ = first_crossing_cuda(
        lanes.to(torch.int32).contiguous(),
        prices.reshape(lanes.shape).to(torch.float32).contiguous(),
        budgets.reshape(-1, num_campaigns).to(torch.float32).contiguous(),
        num_campaigns=num_campaigns, block=block, spend=False)
    return cap.reshape(winners.shape[:-1] + (num_campaigns,))


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
    activation mask: ``ops.segment_resolve`` for one lane (on CUDA one
    ``segment_resolve`` launch, which reads the segment table in place; on
    the CPU the (N, C) mask ``segments.masks[seg_ids]`` and one resolve)."""
    # ops imports this module (REDUCE_BLOCKS), so it is imported here
    from repro_torch.kernels.auction_resolve import ops as resolve_ops
    winners, prices = resolve_ops.segment_resolve(
        values, rule.multipliers.reshape(1, -1),
        torch.as_tensor(rule.reserve).reshape(1),
        segments.boundaries.reshape(1, -1), segments.masks[None],
        second_price=rule.kind == "second_price")
    return winners[0], prices[0]


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
