"""Multi-slot auctions — the paper's §8 generality claim, made executable
(port of ``repro.core.multislot``).

A search-result page sells ``slots`` ad slots per query: the top active
bidders win, each paying its own bid scaled by a position discount
(first-price position auction). The burnout machinery is unchanged: ``f``
returns up to ``slots`` spend increments per event, still satisfying ``a^c
= 0 => f^c = 0``, so SORT2AGGREGATE applies as it is. This module gives the
multi-slot resolve, a sequential oracle, a segment aggregate and the
refinement, with the single-slot versions' interfaces.

``repro`` has no Pallas kernel here, so the port uses tensor ops around the
``first_crossing`` kernel: on CUDA the spend totals and the cap times of
the flattened (event, slot) sales come from one ``first_crossing`` call in
event order, with no atomics. Ties: ``jax.lax.top_k`` puts the lower
campaign index first among equal bids, and ``torch.topk`` does not promise
an order, so the top bids are taken by a stable descending sort.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import auction
from repro_torch.core import segments as seg_lib
from repro_torch.core.types import AuctionRule, Segments, SimResult, \
    never_capped
from repro_torch.device import DeviceLike

NEG = -2.0 ** 30


@dataclasses.dataclass(frozen=True)
class MultiSlotRule:
    base: AuctionRule
    discounts: torch.Tensor       # (slots,) position discounts, 1, .5, ...

    @staticmethod
    def first_price(num_campaigns: int, slots: int = 3, decay: float = 0.5,
                    *, device: DeviceLike = None) -> "MultiSlotRule":
        base = AuctionRule.first_price(num_campaigns, device=device)
        dev = base.multipliers.device
        exps = torch.arange(slots, dtype=torch.float32, device=dev)
        return MultiSlotRule(
            base=base, discounts=torch.pow(
                torch.tensor(decay, dtype=torch.float32, device=dev), exps))

    @property
    def slots(self) -> int:
        return self.discounts.shape[0]


def resolve_multislot(values: torch.Tensor, active: torch.Tensor,
                      rule: MultiSlotRule
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, C) values under a (C,) or (T, C) activation. Returns ``(winners
    (T, slots) int32 [-1 = unfilled], prices (T, slots) float32)``: the
    eligible bids in descending order, the lower index first among equal
    bids (``lax.top_k``'s order), each price the bid times its slot's
    discount."""
    b = auction.bids(values, rule.base)
    eligible = active & (b > rule.base.reserve)
    masked = torch.where(eligible, b, NEG)
    top, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top, idx = top[..., :rule.slots], idx[..., :rule.slots]
    sale = top > NEG
    prices = torch.where(sale, top * rule.discounts, 0.0)
    winners = torch.where(sale, idx.to(torch.int32), -1)
    return winners, prices.to(torch.float32)


def spend_sums_multislot(winners: torch.Tensor, prices: torch.Tensor,
                         num_campaigns: int, weights=None) -> torch.Tensor:
    """(C,) totals of (T, slots) sales, added in (event, slot) order."""
    s = winners.shape[-1]
    p = prices.reshape(-1)
    if weights is not None:
        p = p * torch.repeat_interleave(weights, s)
    return auction.spend_sums(winners.reshape(-1), p, num_campaigns)


def sequential_replay_multislot(values: torch.Tensor, budgets: torch.Tensor,
                                rule: MultiSlotRule) -> SimResult:
    """Exact serial oracle with ``slots`` winners per event: a loop over
    the events, each adding its sales to the spends (one float32 add per
    campaign: the top bids are distinct campaigns)."""
    n_events, n_campaigns = values.shape
    dev = values.device
    sentinel = never_capped(n_events)
    budgets = budgets.to(torch.float32)
    s = torch.zeros(n_campaigns, dtype=torch.float32, device=dev)
    cap = torch.full((n_campaigns,), sentinel, dtype=torch.int32, device=dev)
    winners = torch.empty((n_events, rule.slots), dtype=torch.int32,
                          device=dev)
    prices = torch.empty((n_events, rule.slots), dtype=torch.float32,
                         device=dev)
    for n in range(n_events):
        w, p = resolve_multislot(values[n:n + 1], (s < budgets)[None, :],
                                 rule)
        winners[n], prices[n] = w[0], p[0]
        idx = torch.where(w[0] >= 0, w[0], n_campaigns).long()
        # unfilled slots land in bucket C, which is dropped
        inc = torch.zeros(n_campaigns + 1, dtype=torch.float32,
                          device=dev).scatter_(0, idx, p[0])
        s = s + inc[:n_campaigns]
        cap = torch.where((s >= budgets) & (cap == sentinel), n + 1, cap)
    return SimResult(final_spend=s, cap_times=cap.to(torch.int32),
                     winners=winners, prices=prices)


def auction_first_crossing(flat_w: torch.Tensor, flat_p: torch.Tensor,
                           budgets: torch.Tensor, n_campaigns: int,
                           slots: int, n_events: int,
                           block: int = 4096) -> torch.Tensor:
    """Cap times of the flattened (event, slot) sales, mapped back to
    1-based event times: ``ceil(flat / slots)``, ``never_capped(N)`` past
    the log."""
    cap_flat = seg_lib.first_crossing_times(flat_w, flat_p, budgets,
                                            n_campaigns, block)
    return _event_caps(cap_flat, slots, n_events)


def _event_caps(cap_flat: torch.Tensor, slots: int,
                n_events: int) -> torch.Tensor:
    capped = cap_flat <= n_events * slots
    return torch.where(capped, (cap_flat + slots - 1) // slots,
                       never_capped(n_events)).to(torch.int32)


def aggregate_multislot(values: torch.Tensor, segments: Segments,
                        budgets: torch.Tensor,
                        rule: MultiSlotRule) -> SimResult:
    """Segment-indexed parallel replay (Step 3) for multi-slot auctions:
    every event resolved under its segment's mask, then the totals and the
    first crossings of the flattened (event, slot) sales, in event order
    (one ``first_crossing`` call on CUDA)."""
    n_events, n_campaigns = values.shape
    masks = segments.masks[segments.seg_ids(n_events)]
    winners, prices = resolve_multislot(values, masks, rule)
    final, cap_flat = seg_lib.crossing_and_spend(
        winners.reshape(-1), prices.reshape(-1), budgets, n_campaigns)
    return SimResult(final_spend=final,
                     cap_times=_event_caps(cap_flat, rule.slots, n_events),
                     winners=winners, prices=prices, segments=segments)


def refine_segments_multislot(values: torch.Tensor, budgets: torch.Tensor,
                              rule: MultiSlotRule, cap_times0,
                              max_iters: int = 10):
    """Step-2 fixed point, multi-slot flavour, on the host. Returns ``(cap
    times (C,) int32, iterations, converged)``."""
    n_events = values.shape[0]
    dev = values.device
    caps = torch.as_tensor(cap_times0).cpu().numpy().astype(np.int64)
    best, best_gap = caps, np.inf
    for it in range(max_iters):
        segs = Segments.from_cap_times(
            torch.from_numpy(caps.astype(np.int32)).to(dev), n_events)
        rep = aggregate_multislot(values, segs, budgets, rule)
        new = rep.cap_times.cpu().numpy().astype(np.int64)
        gap = int(np.max(np.abs(np.minimum(new, n_events + 1)
                                - np.minimum(caps, n_events + 1))))
        if gap < best_gap:
            best, best_gap = caps, gap
        if gap == 0:
            return (torch.from_numpy(caps.astype(np.int32)).to(dev), it + 1,
                    True)
        caps = new
    return torch.from_numpy(best.astype(np.int32)).to(dev), max_iters, False
