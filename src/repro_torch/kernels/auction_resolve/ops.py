"""Public wrappers of the auction-resolve kernels (port of
``repro.kernels.auction_resolve.ops``).

They dispatch on the tensors' device: a CUDA tensor goes to the hand-written
CUDA kernel (:mod:`.round_fused`, :mod:`.sweep_resolve`,
:mod:`.auction_resolve`, :mod:`.segment_resolve`), which launches or
raises; a CPU tensor goes to the plain PyTorch version (:mod:`.ref`),
because the caller asked for the CPU. There is no padding: the kernels take
any N.

C is limited by the kernels' shared memory, and this module holds the
decisions that keep every C a CUDA caller can pass on hand-written kernels
with the same bits: :func:`round_campaign_limits` (the round back-ends'
limits, which ``core.executor.pick_resolve`` reads; above them
:func:`resolve_lanes`, which takes any C), :func:`resolve_masked`
and :func:`auction_resolve` (their sums from ``first_crossing``'s flat sum
at any C; EmbTile above its C·d limit in campaign chunks,
:func:`resolve_by_campaign_chunks`) and :func:`segment_resolve` (above the
segment kernel's limit, a MatrixTile resolve per lane,
:func:`segment_resolve_per_lane`). :data:`PATHS` counts the flat sums and
the calls that took the last two routes.
"""
from __future__ import annotations

import torch

from repro_torch.core.segments import REDUCE_BLOCKS
from repro_torch.core.types import Segments
from repro_torch.kernels.auction_resolve import auction_resolve as ar_kernel
from repro_torch.kernels.auction_resolve import ref
from repro_torch.kernels.auction_resolve import sweep_resolve as sr_kernel
from repro_torch.kernels.auction_resolve.auction_resolve import (
    resolve_emb_cuda, resolve_lanes_cuda, resolve_matrix_cuda)
from repro_torch.kernels.auction_resolve import round_fused as cuda_kernels
from repro_torch.kernels.auction_resolve import segment_resolve as sg_kernel
from repro_torch.kernels.auction_resolve.first_crossing import \
    first_crossing_cuda
from repro_torch.kernels.auction_resolve.sweep_resolve import \
    sweep_resolve_cuda

PATHS = {"auction_resolve_flat_sums": 0, "auction_resolve_chunked": 0,
         "segment_resolve_per_lane": 0}


def reset_paths() -> None:
    for name in PATHS:
        PATHS[name] = 0


def round_campaign_limits() -> dict:
    """The largest C each CUDA round back-end holds in shared memory:
    ``"fused"`` (``round_fused``) and ``"sweep_resolve"``; builds both
    kernels."""
    return {"fused": cuda_kernels.max_campaigns(),
            "sweep_resolve": sr_kernel.max_campaigns()}


def _flat_sums(winners: torch.Tensor, prices: torch.Tensor,
               c: int) -> torch.Tensor:
    """(C,) event-ordered sums of one design's resolved events by
    ``first_crossing``'s flat sum, the sums of every CUDA resolve: each
    campaign's prices added in event order from 0.0, the bits of the plain
    version's ``index_add_`` on the CPU (card tests hold the two)."""
    _, sums = first_crossing_cuda(winners[None], prices[None], None,
                                  num_campaigns=c)
    PATHS["auction_resolve_flat_sums"] += 1
    return sums[0]


def resolve_by_campaign_chunks(resolve, num_campaigns: int, chunk: int,
                               reserve: torch.Tensor, *, second_price: bool):
    """One design's ``(winners, prices)`` from resolves of campaign chunks
    of at most ``chunk`` campaigns, merged exactly. ``resolve(c0, c1,
    second)`` resolves campaigns [c0, c1) alone and returns their
    ``(winners, prices)`` (winners chunk-relative, -1 = no sale). A chunk's
    first-price resolve gives its winner and top bid, its second-price
    resolve ``max(second bid, reserve)``. The winner is the largest top bid,
    an earlier chunk winning a tie (the first index wins); its second price
    is the winning chunk's, maxed with the other chunks' top bids. Every
    step is a comparison or a max, so the bits are the unchunked resolve's.
    """
    best = win = sec = None
    for c0 in range(0, num_campaigns, chunk):
        c1 = min(c0 + chunk, num_campaigns)
        w, top = resolve(c0, c1, False)
        sale = w >= 0
        top = torch.where(sale, top, float("-inf"))
        w = torch.where(sale, w + c0, -1)
        if best is None:
            best = torch.full_like(top, float("-inf"))
            win = torch.full_like(w, -1)
            sec = torch.broadcast_to(reserve.to(top), top.shape)
        better = top > best
        if second_price:
            _, chunk_sec = resolve(c0, c1, True)
            sec = torch.where(better, torch.maximum(best, chunk_sec),
                              torch.maximum(sec, top))
        win = torch.where(better, w, win)
        best = torch.where(better, top, best)
    price = sec if second_price else best
    return win.to(torch.int32), torch.where(win >= 0, price, 0.0).to(
        torch.float32)


def _lane_inputs(multipliers, active, reserves, n_scenarios, device):
    mult = multipliers.to(device=device, dtype=torch.float32).contiguous()
    act = active.to(device=device, dtype=torch.bool).contiguous()
    res = torch.as_tensor(reserves, dtype=torch.float32, device=device)
    return mult, act, res.expand(n_scenarios).contiguous()


def _i32(x, device, n_scenarios):
    return torch.as_tensor(x, dtype=torch.int32, device=device).expand(
        n_scenarios).contiguous()


def _design_inputs(multipliers, active, reserve, live, device):
    mult = multipliers.to(device=device, dtype=torch.float32).contiguous()
    act = active.to(device=device, dtype=torch.bool).contiguous()
    res = torch.as_tensor(reserve, dtype=torch.float32,
                          device=device).reshape(())
    if live is not None:
        live = live.to(device=device, dtype=torch.bool).contiguous()
    return mult, act, res, live


def auction_resolve(event_emb: torch.Tensor, campaign_emb: torch.Tensor,
                    multipliers: torch.Tensor, active: torch.Tensor,
                    reserve=0.0, *, second_price: bool = False):
    """One design's auctions with valuations built from embeddings (Eq.
    12): event embeddings (N, d), campaign embeddings (C, d) (float32 or
    bf16), multipliers (C,), a (C,) or (N, C) activation. Returns
    ``(winners (N,) int32 [-1 = no sale], prices (N,) float32, spend sums
    (C,) float32)``, the sums added in event order. Any N, C and d: on
    CUDA, campaigns whose embeddings do not fit the kernel's shared memory
    are resolved in chunks that fit (:func:`resolve_by_campaign_chunks`)
    and the sums are always :func:`_flat_sums`."""
    dev = event_emb.device
    mult, act, res, _ = _design_inputs(multipliers, active, reserve, None,
                                       dev)
    if dev.type == "cpu":
        return ref.auction_resolve_ref(event_emb, campaign_emb, mult, act,
                                       res, second_price=second_price)
    e, r = event_emb, campaign_emb.to(dev)
    if e.dtype != r.dtype or e.dtype != torch.bfloat16:
        e, r = e.to(torch.float32), r.to(torch.float32)   # exact widening
    e, r = e.contiguous(), r.contiguous()
    c, d = r.shape
    chunk = ar_kernel.emb_max_campaigns(d)
    if c <= chunk or chunk < 1:           # fits, or the wrapper refuses d
        winners, prices = resolve_emb_cuda(e, r, mult, act, None, res,
                                           second_price=second_price)
        return winners, prices, _flat_sums(winners, prices, c)
    PATHS["auction_resolve_chunked"] += 1

    def resolve(c0, c1, second):
        return resolve_emb_cuda(e, r[c0:c1], mult[c0:c1],
                                act[..., c0:c1].contiguous(), None, res,
                                second_price=second)

    winners, prices = resolve_by_campaign_chunks(
        resolve, c, chunk, res, second_price=second_price)
    return winners, prices, _flat_sums(winners, prices, c)


def resolve_masked(values: torch.Tensor, multipliers: torch.Tensor,
                   active: torch.Tensor, reserve, live=None, *,
                   second_price: bool = False, sums: bool = True):
    """One design's auctions over a valuation matrix ``values`` (N, C)
    under a (C,) or (N, C) activation; rows whose ``live`` (N,) is False
    are not sold. Returns ``(winners (N,) int32, prices (N,) float32, spend
    sums (C,) float32 or None when ``sums`` is False)``, the sums added in
    event order. The resolve of the segment replays above
    ``segment_resolve``'s limit (:func:`segment_resolve_per_lane`) and of
    Algorithm 4's batches on the CPU. On CUDA one lane of the matrix
    kernel (:func:`resolve_lanes`'s), and the sums are
    :func:`_flat_sums`."""
    dev = values.device
    mult, act, res, live = _design_inputs(multipliers, active, reserve, live,
                                          dev)
    if dev.type == "cpu":
        winners, prices, total = ref.resolve_masked_ref(
            values, mult, act, res, live, second_price=second_price)
        return winners, prices, total if sums else None
    winners, prices = resolve_matrix_cuda(
        values.to(torch.float32).contiguous(), mult, act, live, res,
        second_price=second_price)
    return winners, prices, (_flat_sums(winners, prices, values.shape[1])
                             if sums else None)


def resolve_lanes(values: torch.Tensor, multipliers: torch.Tensor,
                  active: torch.Tensor, reserves=0.0, *,
                  second_price: bool = False):
    """S lanes of one valuation matrix ``values`` (N, C), each under its
    own multipliers and (C,) activation (``multipliers``, ``active`` (S,
    C)) and reserve (``reserves`` (S,) or a scalar). Returns ``(winners
    (S, N) int32 [-1 = no sale], prices (S, N) float32)``, bit for bit each
    lane's :func:`resolve_masked`. The resolve of the round back-end that
    takes any C (``core.executor.ANY_C_BACKEND``): on CUDA one
    ``auction_resolve`` launch for all lanes (reading the matrix once) and
    one merge of its campaign chunks; on the CPU
    :func:`ref.resolve_lanes_ref`."""
    s = multipliers.shape[0]
    dev = values.device
    mult, act, res = _lane_inputs(multipliers, active, reserves, s, dev)
    if dev.type == "cpu":
        return ref.resolve_lanes_ref(values, mult, act, res,
                                     second_price=second_price)
    return resolve_lanes_cuda(values.to(torch.float32).contiguous(), mult,
                              act, res, second_price=second_price)


def segment_resolve(values: torch.Tensor, multipliers: torch.Tensor,
                    reserves, boundaries: torch.Tensor, masks: torch.Tensor,
                    *, second_price: bool = False, offset: int = 0):
    """Every event resolved for S lanes, each under its own segment table:
    row n of lane s under ``masks[s][j]``, j the segment of global event
    ``offset + n`` in ``boundaries[s]`` (``Segments.seg_ids``), so a chunk
    of the log gets the rows of a whole-log call. ``multipliers`` (S, C),
    ``reserves`` (S,) or a scalar, ``boundaries`` (S, K+2), ``masks`` (S,
    K+1, C). Returns ``(winners (S, N) int32, prices (S, N) float32)``, bit
    for bit each lane's ``resolve_masked`` on its gathered (N, C) mask. On
    CUDA one ``segment_resolve`` launch for all lanes, or, above its
    shared memory, :func:`segment_resolve_per_lane`."""
    s = multipliers.shape[0]
    dev = values.device
    mult = multipliers.to(device=dev, dtype=torch.float32).contiguous()
    res = torch.as_tensor(reserves, dtype=torch.float32,
                          device=dev).expand(s).contiguous()
    bounds = boundaries.to(device=dev, dtype=torch.int32).contiguous()
    m = masks.to(device=dev, dtype=torch.bool).contiguous()
    if dev.type == "cpu":
        return ref.segment_resolve_plain(values, mult, res, bounds, m,
                                         second_price, offset=offset)
    v = values.to(torch.float32).contiguous()
    if values.shape[1] > sg_kernel.max_campaigns():
        PATHS["segment_resolve_per_lane"] += 1
        return segment_resolve_per_lane(v, mult, res, bounds, m,
                                        second_price=second_price,
                                        offset=offset)
    return sg_kernel.segment_resolve_cuda(v, mult, res, bounds, m,
                                          second_price=second_price,
                                          offset=offset)


def segment_resolve_per_lane(values: torch.Tensor, mult: torch.Tensor,
                             reserves: torch.Tensor, boundaries: torch.Tensor,
                             masks: torch.Tensor, *, second_price: bool,
                             offset: int = 0):
    """:func:`segment_resolve` one lane at a time: each lane's (N, C) mask
    gathered from its table and one :func:`resolve_masked` (the MatrixTile
    kernel on CUDA). The route above the segment kernel's shared memory."""
    n = values.shape[0]
    out = []
    for s in range(mult.shape[0]):
        seg_ids = Segments(boundaries=boundaries[s],
                           masks=masks[s]).seg_ids(n, offset)
        out.append(resolve_masked(values, mult[s], masks[s][seg_ids],
                                  reserves[s], second_price=second_price,
                                  sums=False)[:2])
    return (torch.stack([w for w, _ in out]),
            torch.stack([p for _, p in out]))


def sweep_resolve(values: torch.Tensor, multipliers: torch.Tensor,
                  active: torch.Tensor, reserves=0.0, *,
                  second_price: bool = False):
    """Resolve S scenario lanes against one (N, C) valuation matrix under
    an (S, C) or (S, N, C) activation. Returns ``(winners (S, N) int32
    [-1 = no sale], prices (S, N) float32, spend sums (S, C) float32)``;
    winners and prices are bit for bit the per-lane
    ``repro_torch.core.auction.resolve``."""
    s = multipliers.shape[0]
    dev = values.device
    mult, act, res = _lane_inputs(multipliers, active, reserves, s, dev)
    if dev.type == "cpu":
        return ref.sweep_resolve_ref(values, mult, act, res,
                                     second_price=second_price)
    return sweep_resolve_cuda(values, mult, act, res,
                              second_price=second_price,
                              reduce_blocks=REDUCE_BLOCKS)


def round_fused(values: torch.Tensor, multipliers: torch.Tensor,
                active: torch.Tensor, reserves, budgets: torch.Tensor,
                s_hat: torch.Tensor, n_hat: torch.Tensor,
                lane_alive: torch.Tensor, *, reduce_blocks: int,
                second_price: bool = False, skip_retired: bool = True):
    """One fused Algorithm-2 round for S lanes: resolve, rate partials over
    ``[n_hat, N)``, cap-out prediction, block partials over ``[n_hat,
    n_next)``. Returns ``(rate_parts (S, G, C), block_parts (S, G, C),
    c_next (S,) int32, no_cap (S,) bool, n_next (S,) int32)``; fold a
    partials tensor over G with ``segments.fold_blocks``.

    On CUDA, lanes with ``lane_alive`` False do no work when
    ``skip_retired`` (their outputs are zeros, discarded by the drivers);
    the plain CPU version computes every lane."""
    n, _ = values.shape
    s = multipliers.shape[0]
    dev = values.device
    block_size = -(-n // reduce_blocks)
    mult, act, res = _lane_inputs(multipliers, active, reserves, s, dev)
    n_hat = _i32(n_hat, dev, s)
    b = budgets.to(device=dev, dtype=torch.float32).contiguous()
    sh = s_hat.to(device=dev, dtype=torch.float32).contiguous()
    if dev.type == "cpu":
        return ref.round_fused_ref(values, mult, act, res, b, sh, n_hat,
                                   block_size=block_size,
                                   reduce_blocks=reduce_blocks,
                                   second_price=second_price)
    return cuda_kernels.round_fused_cuda(
        values, mult, act, res, b, sh, n_hat,
        lane_alive.to(torch.bool).contiguous(), block_size=block_size,
        reduce_blocks=reduce_blocks, second_price=second_price,
        skip_retired=skip_retired)


def sweep_partials(values: torch.Tensor, multipliers: torch.Tensor,
                   active: torch.Tensor, reserves, lo, hi,
                   lane_alive: torch.Tensor, offset: int = 0, *,
                   n_events_global: int, reduce_blocks: int,
                   second_price: bool = False,
                   skip_retired: bool = True) -> torch.Tensor:
    """One fused resolve+reduce pass over a slice of the log: (S, G, C)
    canonical partials of the events in each lane's global window ``[lo,
    hi)``, the slice's rows placed on the global grid at ``offset``."""
    n_local, _ = values.shape
    s = multipliers.shape[0]
    dev = values.device
    block_size = -(-n_events_global // reduce_blocks)
    mult, act, res = _lane_inputs(multipliers, active, reserves, s, dev)
    lo, hi = _i32(lo, dev, s), _i32(hi, dev, s)
    if dev.type == "cpu":
        return ref.fused_partials_ref(values, mult, act, res, lo, hi,
                                      block_size=block_size,
                                      reduce_blocks=reduce_blocks,
                                      second_price=second_price,
                                      index_offset=int(offset))
    return cuda_kernels.sweep_partials_cuda(
        values, mult, act, res, lo, hi, lane_alive.to(torch.bool).contiguous(),
        offset=int(offset), n_global=n_events_global, block_size=block_size,
        reduce_blocks=reduce_blocks, second_price=second_price,
        skip_retired=skip_retired)
