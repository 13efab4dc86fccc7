"""Plain PyTorch versions of the auction-resolve kernels (port of
``repro.kernels.auction_resolve.ref``).

These are what the CUDA kernels in ``csrc/round_fused.cu``,
``csrc/sweep_resolve.cu``, ``csrc/auction_resolve.cu`` and
``csrc/segment_resolve.cu`` compute, written as ordinary tensor code: the
CPU path runs them, and ``chip_smoke.py`` holds the kernels against them on the
card. The partials go through the same
event-ordered ``index_add_`` and the same in-order block fold as
:mod:`repro_torch.core.segments`; the prediction repeats
``repro_torch.core.executor.lane_predict``'s arithmetic vectorised over
lanes (kept here so the kernel package does not import the executor).
"""
from __future__ import annotations

import torch

from repro_torch.core.segments import REDUCE_BLOCKS, fold_blocks
from repro_torch.core.types import Segments
from repro_torch.floats import fma
from repro_torch.kernels.auction_resolve.auction_resolve import inv_scale

NEG = -2.0 ** 30
# csrc/lane_resolve.cuh: rows a tile (one thread a row), the most lanes an
# item takes
LANE_TILE, LANE_MAX = 512, 8
# csrc/vi.cu: threads a CTA that resolve rows (one lane);
# csrc/segment_resolve.cu: rows a tile, lanes a CTA, CTAs of the grid (one
# an SM of an H100), and the lane count up to which a CTA takes one tile
VI_THREADS = 256
SEGMENT_TILE, SEGMENT_LANES, SEGMENT_CTAS = 128, 32, 132
SEGMENT_FEW_LANES = 8           # at most this many: a CTA a tile


def _resolve_rows(values: torch.Tensor, multipliers: torch.Tensor,
                  active: torch.Tensor, reserve, second_price: bool):
    """(winners (T,) int32 [-1 = no sale], prices (T,) float32) of a (T, C)
    valuation tile under one lane's (C,) or (T, C) activation."""
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
    return winners, prices.to(torch.float32)


def valuations(event_emb: torch.Tensor,
               campaign_emb: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (12) as ``csrc/auction_resolve.cu``'s EmbTile computes it:
    (T, d), (C, d) -> (T, C) ``min(exp(dot * s) / 10, 1)`` with ``s`` the
    float32 ``1 / (2 sqrt d)``, each dot an in-order float32 loop over d
    (one rounded product and one rounded add a term). Embeddings are
    widened to float32 first. ``repro``'s version divides a matmul by
    ``2 sqrt d``, so the two agree to float32 tolerance."""
    e = event_emb.to(torch.float32)
    r = campaign_emb.to(torch.float32)
    d = e.shape[-1]
    dot = e[:, :1] * r[:, 0]
    for j in range(1, d):
        dot = dot + e[:, j:j + 1] * r[:, j]
    f32 = dict(dtype=torch.float32, device=e.device)
    scale = torch.tensor(inv_scale(d), **f32)
    # a tensor divisor: PyTorch on CUDA multiplies by the reciprocal of a
    # Python-number divisor, which rounds differently from the kernel's
    # IEEE division
    ten = torch.tensor(10.0, **f32)
    return torch.minimum(torch.exp(dot * scale) / ten, torch.ones((), **f32))


def resolve_masked_ref(values: torch.Tensor, multipliers: torch.Tensor,
                       active: torch.Tensor, reserve,
                       live: torch.Tensor | None = None,
                       second_price: bool = False):
    """One design's resolve of a (T, C) valuation tile under a (C,) or
    (T, C) activation, rows with ``live`` False not sold. Returns (winners
    (T,) int32 [-1 = no sale], prices (T,) float32, spend sums (C,)); the
    sums are added in event order by ``index_add_`` (on the CPU; with
    atomics on CUDA)."""
    c = values.shape[1]
    act = active if live is None else active & live[:, None]
    winners, prices = _resolve_rows(values, multipliers, act, reserve,
                                    second_price)
    sums = torch.zeros(c + 1, dtype=torch.float32, device=values.device)
    sums.index_add_(0, torch.where(winners < 0, c, winners).long(), prices)
    return winners, prices, sums[:c]


def resolve_lanes_ref(values: torch.Tensor, multipliers: torch.Tensor,
                      active: torch.Tensor, reserves: torch.Tensor,
                      second_price: bool = False):
    """The plain version of ``csrc/auction_resolve.cu``'s matrix kernel:
    S lanes of one (N, C) valuation matrix, multipliers and activations (S,
    C), reserves (S,), resolved one lane at a time. Returns ``(winners (S,
    N) int32, prices (S, N) float32)``."""
    out = [_resolve_rows(values, multipliers[s], active[s], reserves[s],
                         second_price) for s in range(multipliers.shape[0])]
    n = values.shape[0]
    if not out:
        return (torch.empty((0, n), dtype=torch.int32),
                torch.empty((0, n), dtype=torch.float32))
    return (torch.stack([w for w, _ in out]),
            torch.stack([p for _, p in out]))


def resolve_chunks_ref(values: torch.Tensor, multipliers: torch.Tensor,
                       active: torch.Tensor, reserves: torch.Tensor, *,
                       chunk_cols: int):
    """The resolve launch of ``csrc/auction_resolve.cu``'s matrix kernel,
    by its split: the columns in chunks of ``chunk_cols``, and per (lane,
    chunk, row) the scan's ``(best, second, win)`` (best and second start
    at the reserve, a bid is NaN where its campaign is inactive, ``win``
    the global column of the chunk's first largest eligible bid or -1).
    Returns the three as (S, K, N) tensors."""
    c = values.shape[1]
    res = reserves.to(torch.float32)
    bids = values.to(torch.float32)[None] * torch.where(
        active, multipliers.to(torch.float32), float("nan"))[:, None]
    out = []
    for c0 in range(0, c, chunk_cols):
        b, s2, w = _slice_top2(bids[..., c0:c0 + chunk_cols], res)
        out.append((b, s2, torch.where(w >= 0, w + c0, -1).to(torch.int32)))
    return tuple(torch.stack(x, dim=1) for x in zip(*out))


def merge_chunks_ref(best: torch.Tensor, sec: torch.Tensor,
                     win: torch.Tensor, second_price: bool = False):
    """The plain version of ``merge_kernel``: per (lane, row) the chunks'
    ``(best, second, win)`` (S, K, N) merged in ascending order; a later
    chunk wins only on a strictly larger best, and the second price is
    then the larger of its second and the earlier best, else of the
    earlier second and its best. Returns ``(winners (S, N) int32, prices
    (S, N) float32)``."""
    b, s2, w = best[:, 0], sec[:, 0], win[:, 0]
    for k in range(1, best.shape[1]):
        bk, sk, wk = best[:, k], sec[:, k], win[:, k]
        better = bk > b
        s2 = torch.where(better, torch.where(sk > b, sk, b),
                         torch.where(bk > s2, bk, s2))
        w = torch.where(better, wk, w)
        b = torch.where(better, bk, b)
    price = s2 if second_price else b
    return w.to(torch.int32), torch.where(w >= 0, price, 0.0).to(
        torch.float32)


def auction_resolve_ref(event_emb: torch.Tensor, campaign_emb: torch.Tensor,
                        multipliers: torch.Tensor, active: torch.Tensor,
                        reserve, second_price: bool = False,
                        live: torch.Tensor | None = None):
    """The embedding-level resolve: :func:`valuations` of the embeddings,
    then :func:`resolve_masked_ref`. Returns (winners (T,) int32, prices
    (T,) float32, spend sums (C,))."""
    return resolve_masked_ref(valuations(event_emb, campaign_emb),
                              multipliers, active, reserve, live,
                              second_price)


def resolve_tile_ref(values: torch.Tensor, multipliers: torch.Tensor,
                     active: torch.Tensor, reserve,
                     second_price: bool = False):
    """Single-scenario resolve of a (T, C) valuation tile under a (C,) or
    (T, C) activation. Returns (winners (T,) int32 [-1 = no sale], prices
    (T,) float32, spend sums (C,))."""
    c = values.shape[1]
    winners, prices = _resolve_rows(values, multipliers, active, reserve,
                                    second_price)
    cols = torch.arange(c, device=values.device)
    sums = ((winners[:, None] == cols) * prices[:, None]).sum(0)
    return winners, prices, sums


def sweep_resolve_ref(values: torch.Tensor, multipliers: torch.Tensor,
                      active: torch.Tensor, reserves: torch.Tensor,
                      second_price: bool = False, *,
                      reduce_blocks: int = REDUCE_BLOCKS):
    """S lanes resolved against one (N, C) valuation matrix under an
    (S, C) or (S, N, C) activation, one lane at a time. Returns (winners
    (S, N) int32, prices (S, N) float32, spend sums (S, C)). Each lane's
    sums are its canonical block partials (``index_add_``, in event order
    on the CPU) folded over the blocks in order, as the CUDA kernel sums
    them; ``repro``'s oracle sums each lane in another order."""
    n, c = values.shape
    block = -(-n // reduce_blocks)
    ids_blk = (torch.arange(n, device=values.device) // block) * (c + 1)
    winners, prices, sums = [], [], []
    for s in range(multipliers.shape[0]):
        w, p = _resolve_rows(values, multipliers[s], active[s], reserves[s],
                             second_price)
        parts = torch.zeros(reduce_blocks * (c + 1), dtype=torch.float32,
                            device=values.device)
        parts.index_add_(0, ids_blk + torch.where(w < 0, c, w).long(), p)
        winners.append(w)
        prices.append(p)
        sums.append(fold_blocks(parts.reshape(reduce_blocks, c + 1)[:, :c]))
    return torch.stack(winners), torch.stack(prices), torch.stack(sums)


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
        winners, prices = _resolve_rows(values, multipliers[s], active[s],
                                        reserves[s], second_price)
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


def lane_items(live_per_block, n_ctas: int, max_lanes: int = LANE_MAX):
    """The kernels' choice of lanes per item: the most (8, 4, 2) whose items
    (``ceil(live lanes / L)`` per block) still give 3/4 of ``n_ctas`` CTAs
    one each, else 1."""
    for lanes in (8, 4, 2):
        items = sum(-(-n // lanes) for n in live_per_block)
        if lanes <= max_lanes and 4 * items >= 3 * n_ctas:
            return lanes
    return 1


def lane_resolve_ref(values: torch.Tensor, multipliers: torch.Tensor,
                     active: torch.Tensor, reserves: torch.Tensor,
                     lo=None, hi=None, alive=None, *, block_size: int,
                     reduce_blocks: int = REDUCE_BLOCKS,
                     second_price: bool = False, index_offset: int = 0,
                     n_global: int | None = None, skip_retired: bool = False,
                     tile: int = LANE_TILE, n_ctas: int = 132,
                     max_lanes: int = LANE_MAX):
    """What ``csrc/lane_resolve.cuh`` (the core of ``partials_kernel`` and
    ``sweep_resolve_kernel``) computes, by the same split, for tests: bitwise
    :func:`fused_partials_ref` (``lo``/``hi`` the windows, ``None`` = the
    whole log) and :func:`sweep_resolve_ref`.

    * Items: each canonical block g with the lanes whose windows (cut to the
      rows ``values`` holds; empty for a dead lane when ``skip_retired``)
      meet it, in lane order, in groups of L (:func:`lane_items`); (lane,
      block) pairs of no item stay zero.
    * An item's rows: the union of its lanes' windows in g, ``tile`` rows at
      a time, each row resolved for each of the item's lanes, the rows
      outside a lane's window unsold.
    * The walk: per lane, tile after tile, each campaign's sales in the
      tile's row order onto its running sum, from 0.0 (``index_add_``, in
      order on the CPU).

    Returns ``(parts (S, G, C), winners (S, n) int32, prices (S, n)
    float32)``; a (lane, row) no item covers has winner -1, price 0."""
    n_local, c = values.shape
    s_count = multipliers.shape[0]
    dev = values.device
    n_global = index_offset + n_local if n_global is None else n_global
    per_event = active.ndim == 3
    res = torch.as_tensor(reserves, dtype=torch.float32,
                          device=dev).expand(s_count)
    w0 = torch.full((s_count,), index_offset, dtype=torch.int64)
    if lo is not None:
        w0 = torch.maximum(w0, lo.to(torch.int64).cpu())
    w1 = torch.full((s_count,), n_global, dtype=torch.int64)
    if hi is not None:
        w1 = hi.to(torch.int64).cpu()
    w1 = torch.clamp(w1, max=index_offset + n_local)
    if skip_retired:
        dead = ~alive.cpu()
        w0, w1 = torch.where(dead, 0, w0), torch.where(dead, 0, w1)

    def in_block(s, g):
        a = max(int(w0[s]), g * block_size)
        b = min(int(w1[s]), (g + 1) * block_size)
        return a, b

    live = [[s for s in range(s_count)
             if in_block(s, g)[0] < in_block(s, g)[1]]
            for g in range(reduce_blocks)]
    lanes_per_item = lane_items([len(x) for x in live], n_ctas, max_lanes)
    parts = torch.zeros((s_count, reduce_blocks, c), dtype=torch.float32,
                        device=dev)
    winners = torch.full((s_count, n_local), -1, dtype=torch.int32,
                         device=dev)
    prices = torch.zeros((s_count, n_local), dtype=torch.float32, device=dev)
    for g in range(reduce_blocks):
        for j in range(0, len(live[g]), lanes_per_item):
            lanes = live[g][j:j + lanes_per_item]
            wins = [in_block(s, g) for s in lanes]
            u0, u1 = min(a for a, _ in wins), max(b for _, b in wins)
            acc = torch.zeros((len(lanes), c), dtype=torch.float32,
                              device=dev)
            for t0 in range(u0, u1, tile):
                rows = torch.arange(t0, min(t0 + tile, u1), device=dev)
                v = values[rows - index_offset]
                for k, s in enumerate(lanes):
                    act = active[s][rows] if per_event else active[s]
                    win, price = _resolve_rows(v, multipliers[s], act,
                                               res[s], second_price)
                    a, b = wins[k]
                    w = torch.where((rows >= a) & (rows < b), win, -1)
                    p = torch.where(w >= 0, price, 0.0)
                    sold = w >= 0
                    acc[k].index_add_(0, w[sold].long(), p[sold])
                    winners[s, rows - index_offset] = w
                    prices[s, rows - index_offset] = p
            for k, s in enumerate(lanes):
                parts[s, g] = acc[k]
    return parts, winners, prices


def segment_resolve_plain(values: torch.Tensor, multipliers: torch.Tensor,
                          reserves: torch.Tensor, boundaries: torch.Tensor,
                          masks: torch.Tensor, second_price: bool = False, *,
                          offset: int = 0):
    """The plain version of ``csrc/segment_resolve.cu``: each lane's (N, C)
    mask gathered from its segment table (``masks[s][seg_ids]``, row n
    being global event ``offset + n``) and the events resolved under it,
    one lane at a time. ``multipliers`` (S, C), ``reserves`` (S,),
    ``boundaries`` (S, K+2), ``masks`` (S, K+1, C). Returns ``(winners (S,
    N) int32, prices (S, N) float32)``."""
    n = values.shape[0]
    out = []
    for s in range(multipliers.shape[0]):
        seg_ids = Segments(boundaries=boundaries[s],
                           masks=masks[s]).seg_ids(n, offset)
        out.append(_resolve_rows(values, multipliers[s], masks[s][seg_ids],
                                 reserves[s], second_price))
    return (torch.stack([w for w, _ in out]),
            torch.stack([p for _, p in out]))


def segment_resolve_ref(values: torch.Tensor, multipliers: torch.Tensor,
                        reserves: torch.Tensor, boundaries: torch.Tensor,
                        masks: torch.Tensor, second_price: bool = False, *,
                        tile: int = SEGMENT_TILE, lanes: int | None = None,
                        n_ctas: int | None = None, offset: int = 0):
    """What ``csrc/segment_resolve.cu`` computes, by its split, for tests
    (bitwise :func:`segment_resolve_plain`): tiles of ``tile`` rows; lanes
    ``lanes`` at a time, each group on ``min(tiles, n_ctas)`` CTAs, a CTA a
    contiguous run of tiles (the kernel's choice by default: with 8 lanes
    or fewer a CTA a tile, else 32 lanes a CTA on ``SEGMENT_CTAS``); per
    CTA and lane, the segment at the run's
    first row (the inner boundaries at or below it, as global events
    ``offset + row``) and its next boundary, carried from tile to tile; in
    a tile, a lane's first piece (its current segment up to the next
    boundary) resolved under that segment's (C,) mask, then, round by
    round, each boundary inside the tile: the lane advances one segment and
    the piece up to the following boundary (empty for a duplicate) is
    resolved on its own. Rows no piece covers keep winner -2 and a NaN
    price."""
    n, _ = values.shape
    s_count, k2 = boundaries.shape
    k = k2 - 2
    dev = values.device
    winners = torch.full((s_count, n), -2, dtype=torch.int32, device=dev)
    prices = torch.full((s_count, n), float("nan"), dtype=torch.float32,
                        device=dev)
    bounds = boundaries.to(torch.int64).cpu() - offset   # local rows

    def piece(s, p0, p1, j):
        w, p = _resolve_rows(values[p0:p1], multipliers[s], masks[s, j],
                             reserves[s], second_price)
        winners[s, p0:p1] = w
        prices[s, p0:p1] = p

    tiles = -(-n // tile)
    few = s_count <= SEGMENT_FEW_LANES
    lanes = lanes or (SEGMENT_FEW_LANES if few else SEGMENT_LANES)
    ctas = min(tiles, n_ctas or (tiles if few else SEGMENT_CTAS))
    for s0 in range(0, s_count, lanes):
        for x in range(ctas):
            t0, t1 = x * tiles // ctas, (x + 1) * tiles // ctas
            for s in range(s0, min(s0 + lanes, s_count)):
                inner = bounds[s, 1:k + 1]
                seg = int((inner <= t0 * tile).sum())
                nxt = int(bounds[s, seg + 1]) if seg < k else n
                for t in range(t0, t1):
                    r0, r1 = t * tile, min((t + 1) * tile, n)
                    if nxt > r0:
                        piece(s, r0, min(nxt, r1), seg)
                    while nxt < r1:
                        seg += 1
                        lo = nxt
                        nxt = int(bounds[s, seg + 1]) if seg < k else n
                        if lo < min(nxt, r1):
                            piece(s, lo, min(nxt, r1), seg)
    return winners, prices


def vi_threads_per_row(batch_size: int) -> int:
    """``csrc/vi.cu``'s threads per batch row: the most, a power of two up
    to 32, that ``batch_size`` rows fill in a CTA's resolving threads."""
    tpr = 32
    while tpr > 1 and tpr * batch_size > VI_THREADS:
        tpr //= 2
    return tpr


def vi_slices(num_campaigns: int, tpr: int) -> list:
    """``csrc/vi.cu``'s column slices of a row, one a thread: slice k takes
    every tpr-th quad from quad k when C is a multiple of 4, else every
    tpr-th column from column k, in ascending order."""
    cols = torch.arange(num_campaigns)
    if num_campaigns % 4:
        return [cols[k::tpr] for k in range(tpr)]
    quads = cols.reshape(-1, 4)
    return [quads[k::tpr].reshape(-1) for k in range(tpr)]


def _slice_top2(bids: torch.Tensor, reserve: torch.Tensor):
    """A thread's scan of its column slice, per (lane, row): ``bids`` (S,
    B, k) in column order, NaN where inactive. Returns ``(best, second,
    win)`` with ``win`` the slice-local first index of the largest eligible
    bid (-1 if none), ``best``/``second`` starting at the reserve."""
    res = reserve[:, None].expand(bids.shape[:-1])
    if bids.shape[-1] == 0:                 # a slice past the last column
        return res, res, torch.full_like(res, -1, dtype=torch.int64)
    masked = torch.where(bids > res[..., None], bids, float("-inf"))
    win = torch.argmax(masked, -1, keepdim=True)
    top = masked.gather(-1, win)[..., 0]
    rest = masked.scatter(-1, win, float("-inf")).amax(-1)
    sale = top > float("-inf")
    return (torch.where(sale, top, res),
            torch.where(rest > float("-inf"), rest, res),
            torch.where(sale, win[..., 0], -1))


def vi_chain_ref(sampled: torch.Tensor, u: torch.Tensor, step: torch.Tensor,
                 denom: torch.Tensor, btilde: torch.Tensor,
                 multipliers: torch.Tensor, reserves: torch.Tensor,
                 pi0: torch.Tensor, *, sample_size: int,
                 second_price: bool = False, track_every: int = 0,
                 elig: torch.Tensor | None = None):
    """What ``csrc/vi.cu`` computes from its own inputs, by its split, for
    tests (bitwise ``core.vi``'s loop and ``repro``'s ``estimate_pi``), all
    lanes at once: ``sampled`` (n_batches·B, C) shared or (S, n_batches·B,
    C) a lane, ``elig`` (S, n_batches·B, C) bool ANDed into the
    activations or None, ``u`` (total, B, 1 or C),
    ``step`` (total,), ``denom`` (n_batches,), ``btilde``, ``multipliers``,
    ``pi0`` (S, C), ``reserves`` (S,). Per step: the batch's rows resolved
    by :func:`vi_threads_per_row` slices (:func:`vi_slices`: interleaved
    quads, or columns when C is not a multiple of 4), each scanned on its
    own, then merged pairwise in the kernel's shuffle order (the larger
    best wins, the lower column on a tie; the second price the larger of
    the loser's best and the winner's second); each campaign's won prices
    added in row order from +0.0, divided only where it won something; the
    update ``clamp(fma(step, btilde - sums / denom, pi), 0, 1)``. Returns
    ``(pi (S, C), history (S, ceil(total / track_every), C) or None)``."""
    total, b, w = u.shape
    n_batches = sampled.shape[-2] // b
    s_count, c = multipliers.shape
    dev = sampled.device
    res = reserves.to(torch.float32)
    pi = pi0.to(torch.float32).clone()
    tpr = vi_threads_per_row(b)
    slices = vi_slices(c, tpr)
    history = []
    for t in range(total):
        bi = t % n_batches
        rows = slice(bi * b, (bi + 1) * b)
        v = sampled[..., rows, :]                    # (B, C) or (S, B, C)
        active = u[t][None] < pi[:, None, :]                   # (S, B, C)
        if elig is not None:
            active = active & elig[:, rows]
        bids = torch.where(active, (v if v.ndim == 3 else v[None])
                           * multipliers[:, None, :], float("nan"))
        live = (bi * b + torch.arange(b, device=dev)) < sample_size
        parts = []
        for sl in slices:
            sl = sl.to(dev)
            best, second, win = _slice_top2(bids[..., sl], res)
            if len(sl):
                win = torch.where(win >= 0, sl[win.clamp(min=0)], -1)
            dead = ~live[None, :]
            parts.append((torch.where(dead, res[:, None], best),
                          torch.where(dead, res[:, None], second),
                          torch.where(dead, -1, win)))
        best, second, win = (torch.stack(x, -1) for x in zip(*parts))
        o = 1
        while o < tpr:
            perm = torch.arange(tpr, device=dev) ^ o
            ob, os_, ow = best[..., perm], second[..., perm], win[..., perm]
            take = (ob > best) | ((ob == best) & (ow >= 0) & (ow < win))
            second = torch.where(take, torch.maximum(best, os_),
                                 torch.maximum(second, ob))
            best = torch.where(take, ob, best)
            win = torch.where(take, ow, win)
            o *= 2
        best, second, win = best[..., 0], second[..., 0], win[..., 0]
        price = torch.where(win >= 0, second if second_price else best, 0.0)
        sums = torch.zeros((s_count, c + 1), dtype=torch.float32, device=dev)
        slot = torch.where(win >= 0, win, c)
        for r in range(b):                                     # row order
            sums.scatter_add_(1, slot[:, r:r + 1], price[:, r:r + 1])
        won = torch.zeros((s_count, c + 1), dtype=torch.bool, device=dev)
        won.scatter_(1, slot, True)
        delta = torch.where(won[:, :c], btilde - sums[:, :c] / denom[bi],
                            btilde)
        pi = torch.clamp(fma(step[t], delta, pi), 0.0, 1.0)
        if track_every and t % track_every == 0:
            history.append(pi)
    hist = torch.stack(history, 1) if track_every else None
    return pi, hist
