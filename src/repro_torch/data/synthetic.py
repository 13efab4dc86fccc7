"""Fully synthetic auction environment — paper §7.1, Eqs. (11)-(13) (port of
``repro.data.synthetic:43-107``).

* event embeddings   e_i = (e_base + 3 xi_i) / 4,  xi_i ~ N(0, I_d)
* campaign embeddings r_c ~ N(0, I_d)
* valuations         v_c(e_i) = min( exp(r_c . e_i / (2 sqrt(d))) / 10, 1 )
* budgets            b^c = k * b_base, k = 1..|C|

The normals come from one CPU ``torch.Generator`` seeded with ``seed``, so a
seed names the same embeddings on every device (they are not ``jax.random``'s
bits; tests that compare with ``repro`` hand both sides the same arrays).
The valuation matrix is built blockwise on ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import auction
from repro_torch.core.types import AuctionRule
from repro_torch.device import DeviceLike, pick_device


@dataclasses.dataclass
class SyntheticEnv:
    values: torch.Tensor          # (N, C) float32
    budgets: torch.Tensor         # (C,) float32
    rule: AuctionRule
    event_emb: torch.Tensor       # (N, d)
    campaign_emb: torch.Tensor    # (C, d)

    @property
    def n_events(self) -> int:
        return self.values.shape[0]

    @property
    def n_campaigns(self) -> int:
        return self.values.shape[1]


def valuation_block(event_emb: torch.Tensor,
                    campaign_emb: torch.Tensor) -> torch.Tensor:
    """Eq. (12) for a block of events: (T, d), (C, d) -> (T, C)."""
    d = event_emb.shape[-1]
    scale = 2.0 * torch.sqrt(torch.tensor(d, dtype=torch.float32))
    logits = event_emb @ campaign_emb.T / scale.to(event_emb.device)
    return torch.clamp(torch.exp(logits) / 10.0, max=1.0).to(torch.float32)


def make_synthetic_env(seed: int, n_events: int = 100_000,
                       n_campaigns: int = 100, emb_dim: int = 10,
                       b_base: float | None = None,
                       target_cap_fraction: float = 0.5,
                       rule: AuctionRule | None = None,
                       block: int = 65_536, *,
                       device: DeviceLike = None) -> SyntheticEnv:
    dev = pick_device(device)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    e_base = torch.randn(emb_dim, generator=gen)
    campaign_emb = torch.randn(n_campaigns, emb_dim, generator=gen).to(dev)
    embs, vals = [], []
    for lo in range(0, n_events, block):
        hi = min(lo + block, n_events)
        xi = torch.randn(hi - lo, emb_dim, generator=gen)
        emb = ((e_base[None, :] + 3.0 * xi) / 4.0).to(dev)
        embs.append(emb)
        vals.append(valuation_block(emb, campaign_emb))
    event_emb = torch.cat(embs)
    values = torch.cat(vals)
    if b_base is None:
        b_base = calibrate_b_base(values, target_cap_fraction)
    budgets = (torch.arange(1, n_campaigns + 1, dtype=torch.float32,
                            device=dev)
               * torch.tensor(b_base, dtype=torch.float32, device=dev))
    rule = rule or AuctionRule.first_price(n_campaigns, device=dev)
    return SyntheticEnv(values=values, budgets=budgets, rule=rule,
                        event_emb=event_emb, campaign_emb=campaign_emb)


def calibrate_b_base(values: torch.Tensor, target_cap_fraction: float = 0.5,
                     iters: int = 12) -> float:
    """Bisect b_base so that ~target fraction of campaigns exhaust
    b^c = k*b, using the uncapped all-active spend as the monotone proxy."""
    n_events, n_campaigns = values.shape
    rule = AuctionRule.first_price(n_campaigns, device=values.device)
    active = torch.ones(n_campaigns, dtype=torch.bool, device=values.device)
    w, p = auction.resolve(values, active, rule)
    u = auction.spend_sums(w, p, n_campaigns).cpu().numpy().astype(np.float64)
    ks = np.arange(1, n_campaigns + 1, dtype=np.float64)
    lo, hi = 1e-6, float(u.max())
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        frac = float((u >= ks * mid).mean())
        if frac > target_cap_fraction:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
