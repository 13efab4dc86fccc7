"""Yahoo-like search-advertising environment — paper §7.2 (port of
``repro.data.yahoo:29-98``).

The real bidding data is gated, so the day is simulated with its published
structure: ~1,000 keywords; each advertiser (campaign) bids a constant,
log-normal amount on 30 random keywords; day 1 has 100,000 auctions and
day 2 150,000 on the same bid landscape, keywords drawn from one Zipf-like
popularity; one budget (2,000) for every bidder; first-price auctions.

A :mod:`repro_torch.prng` key gives ``repro``'s day for the same
``jax.random`` key bit for bit: the same splits, folds, permutations and
draws (``prng.choice`` with ``p``), the bids through XLA CPU's ``exp``
(:func:`repro_torch.floats.exp`), the popularity through the C library's
``powf`` and XLA's summation order (:func:`repro_torch.floats.powf`,
:func:`repro_torch.floats.xla_sum`; 1,000 floats, on the host). The draws
and the tables live on ``device``; their bits are the CPU's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import floats, prng
from repro_torch.core.types import AuctionRule
from repro_torch.device import DeviceLike, pick_device


@dataclasses.dataclass
class YahooLikeEnv:
    bid_table: torch.Tensor       # (C, K) bid per advertiser x keyword; 0 = none
    day1_keywords: torch.Tensor   # (N1,) int32 keyword of each auction
    day2_keywords: torch.Tensor   # (N2,) int32
    budgets: torch.Tensor         # (C,)
    rule: AuctionRule

    def values(self, day: int) -> torch.Tensor:
        """The (N, C) valuations of day 1 or 2: each auction's keyword
        column of the bid table."""
        kws = self.day1_keywords if day == 1 else self.day2_keywords
        return self.bid_table.T[kws.long()]

    @property
    def n_campaigns(self) -> int:
        return self.bid_table.shape[0]


def make_yahoo_like_env(key: torch.Tensor, n_keywords: int = 1000,
                        n_campaigns: int = 200, n_day1: int = 100_000,
                        n_day2: int = 150_000, budget: float = 2000.0,
                        keywords_per_campaign: int = 30,
                        zipf_a: float = 1.1, *,
                        device: DeviceLike = None) -> YahooLikeEnv:
    dev = pick_device(device)
    key = key.to(dev)
    k_bid, k_kw, k_d1, k_d2, k_pop = prng.split(key, 5)

    # each campaign bids a constant log-normal amount on a random subset:
    # campaign c's keywords from the c-th key of a split, its bids from
    # fold_in(k_bid, c), all campaigns' draws at once
    kws = prng.choice(prng.split(k_kw, n_campaigns), n_keywords,
                      keywords_per_campaign)
    c_keys = prng.fold_in(k_bid, torch.arange(n_campaigns, device=dev))
    bids = floats.exp(
        prng.normal(c_keys, (keywords_per_campaign,))
        * torch.tensor(0.5, device=dev)) * torch.tensor(np.float32(0.05),
                                                        device=dev)
    bid_table = torch.zeros((n_campaigns, n_keywords), device=dev)
    bid_table.scatter_(1, kws, bids)

    # one Zipf-like keyword popularity for both days
    ranks = torch.arange(1, n_keywords + 1, dtype=torch.float32)
    probs = floats.powf(ranks, -zipf_a)
    probs = (probs / floats.xla_sum(probs)).to(dev)
    probs = probs[prng.permutation(k_pop, n_keywords)]
    day1 = prng.choice(k_d1, n_keywords, n_day1, replace=True, p=probs)
    day2 = prng.choice(k_d2, n_keywords, n_day2, replace=True, p=probs)
    return YahooLikeEnv(
        bid_table=bid_table, day1_keywords=day1, day2_keywords=day2,
        budgets=torch.full((n_campaigns,), budget, dtype=torch.float32,
                           device=dev),
        rule=AuctionRule.first_price(n_campaigns, device=dev))


def as_is_prediction(day1_spend: torch.Tensor) -> torch.Tensor:
    """Heuristic 1 (Fig. 6): predict day-2 spend = day-1 spend."""
    return day1_spend


def rescaled_prediction(day1_spend: torch.Tensor, n_day1: int, n_day2: int,
                        budgets: torch.Tensor) -> torch.Tensor:
    """Heuristic 2 (Fig. 6): scale by volume, clip at budget."""
    return torch.minimum(day1_spend * (n_day2 / n_day1), budgets)
