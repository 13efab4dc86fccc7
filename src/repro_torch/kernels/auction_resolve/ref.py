"""Plain PyTorch versions of the auction-resolve kernels (port of
``repro.kernels.auction_resolve.ref``).

These are what the CUDA kernels in ``csrc/round_fused.cu``,
``csrc/sweep_resolve.cu`` and ``csrc/auction_resolve.cu`` compute, written
as ordinary tensor code: the CPU
path runs them, and ``chip_smoke.py`` holds the kernels against them on the
card. The partials go through the same
event-ordered ``index_add_`` and the same in-order block fold as
:mod:`repro_torch.core.segments`; the prediction repeats
``repro_torch.core.executor.lane_predict``'s arithmetic vectorised over
lanes (kept here so the kernel package does not import the executor).
"""
from __future__ import annotations

import torch

from repro_torch.core.segments import REDUCE_BLOCKS, fold_blocks
from repro_torch.kernels.auction_resolve.auction_resolve import inv_scale

NEG = -2.0 ** 30


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
