"""Fully synthetic auction environment — paper §7.1, Eqs. (11)-(13) (port of
``repro.data.synthetic:43-107``).

* event embeddings   e_i = (e_base + 3 xi_i) / 4,  xi_i ~ N(0, I_d)
* campaign embeddings r_c ~ N(0, I_d)
* valuations         v_c(e_i) = min( exp(r_c . e_i / (2 sqrt(d))) / 10, 1 )
* budgets            b^c = k * b_base, k = 1..|C|

A day is named by a key or by a seed:

* a :mod:`repro_torch.prng` key (``prng.PRNGKey(k)``) gives ``repro``'s day
  for ``jax.random.PRNGKey(k)`` bit for bit: the normals are
  ``jax.random``'s (split, fold_in, normal), and the valuations repeat
  XLA CPU's float32 arithmetic (:func:`keyed_valuation_block`); the draws
  and the valuations run on ``device``, in elementwise operations, so the
  card gives the CPU's bits;
* an int seed draws the normals from one CPU ``torch.Generator`` (not
  ``jax.random``'s bits) and builds the valuations with ``torch`` ops.

The valuation matrix is built blockwise on ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import floats, prng
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


def keyed_valuation_block(event_emb: torch.Tensor,
                          campaign_emb: torch.Tensor) -> torch.Tensor:
    """Eq. (12) as ``repro``'s jitted ``valuation_block`` computes it on
    XLA's CPU backend: the dot in XLA's order (:func:`floats.xla_dot`),
    the divide by ``2 sqrt(d)`` and by 10 compiled into multiplies by
    their float32 reciprocals, XLA's ``exp`` (:func:`floats.exp`). Raises
    ``ValueError`` for a (C, d) whose dot order was not measured
    (:data:`floats.DOT_CHAINS`): there the bits would not be ``repro``'s."""
    d = event_emb.shape[-1]
    dev = event_emb.device
    inv_scale = np.float32(1.0) / (np.float32(2.0) * np.sqrt(np.float32(d)))
    logits = floats.xla_dot(event_emb, campaign_emb) * torch.tensor(
        inv_scale, device=dev)
    out = floats.exp(logits) * torch.tensor(np.float32(1.0) / np.float32(10),
                                            device=dev)
    return torch.minimum(out, torch.ones((), device=dev))


def keyed_block(key: torch.Tensor, lo: int, hi: int, n_campaigns: int,
                emb_dim: int = 10, *, device: DeviceLike = None):
    """Rows ``[lo, hi)`` of the keyed day, drawn alone (``lo`` the start of
    one of its blocks): ``(event_emb (hi - lo, d), values (hi - lo, C),
    campaign_emb (C, d))``, bit for bit those rows of
    :func:`make_synthetic_env`'s keyed day on any device."""
    k_base, k_xi, k_r, _ = prng.split(key.to(pick_device(device)), 4)
    e_base = prng.normal(k_base, (emb_dim,))
    campaign_emb = prng.normal(k_r, (n_campaigns, emb_dim))
    xi = prng.normal(prng.fold_in(k_xi, lo), (hi - lo, emb_dim))
    emb = (e_base[None, :] + 3.0 * xi) / 4.0
    return emb, keyed_valuation_block(emb, campaign_emb), campaign_emb


def make_synthetic_env(seed, n_events: int = 100_000,
                       n_campaigns: int = 100, emb_dim: int = 10,
                       b_base: float | None = None,
                       target_cap_fraction: float = 0.5,
                       rule: AuctionRule | None = None,
                       block: int = 65_536, *,
                       device: DeviceLike = None) -> SyntheticEnv:
    """The §7.1 day on ``device``: ``seed`` is a :mod:`repro_torch.prng`
    key (``repro``'s day for the same key, bit for bit) or an int seed
    (the port's own ``torch.Generator`` draws)."""
    dev = pick_device(device)
    embs, vals = [], []
    if isinstance(seed, torch.Tensor):
        for lo in range(0, n_events, block):
            emb, v, campaign_emb = keyed_block(
                seed, lo, min(lo + block, n_events), n_campaigns, emb_dim,
                device=dev)
            embs.append(emb)
            vals.append(v)
    else:
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        e_base = torch.randn(emb_dim, generator=gen)
        campaign_emb = torch.randn(n_campaigns, emb_dim,
                                   generator=gen).to(dev)
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
