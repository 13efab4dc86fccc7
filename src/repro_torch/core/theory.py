"""Theory toolbox: the paper's assumptions and bounds as executable checks
(port of ``repro.core.theory``).

* Lemma 5.1 (Hoeffding for sampling without replacement): concentration of
  block sums of ``f`` around their mean;
* Theorem 5.2 / Corollary 5.3: the Algorithm-2 error bound;
* empirical estimators of the structural constants — C (Asm 3.2, small
  individual contribution) and gamma/epsilon (Asm 3.3, smoothness) — so
  tests and benchmarks can check that an environment satisfies the
  assumptions the guarantees need. The probes draw ``jax.random``'s bits
  (:mod:`repro_torch.prng`), and their spend totals are event-ordered
  (:func:`repro_torch.core.auction.spend_sums`: ``first_crossing``'s flat
  sum on CUDA), so they give ``repro``'s numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import auction
from repro_torch.core.types import AuctionRule


def hoeffding_failure_prob(n_events: int, c_const: float, t: float) -> float:
    """Lemma 5.1 RHS: P(|sum - n F| >= t) <= 2 exp(-2 N t^2 / C^2)."""
    return float(2.0 * np.exp(-2.0 * n_events * t**2 / c_const**2))


def thm52_bound(k_campaigns: int, gamma: float, eps: float,
                c_const: float, n_events: int, t: float) -> float:
    """Theorem 5.2 RHS: (1+gamma)^K (C/N + t + gamma*eps + eps)."""
    return float((1.0 + gamma) ** k_campaigns
                 * (c_const / n_events + t + gamma * eps + eps))


def cor53_bound(d_const: float, eps: float, gamma: float,
                c_const: float, n_events: int, t: float) -> float:
    """Corollary 5.3 RHS (gamma <= D/K): e^D (C/N + t + gamma*eps + eps)."""
    return float(np.exp(d_const)
                 * (c_const / n_events + t + gamma * eps + eps))


def estimate_c_const(values: torch.Tensor, rule: AuctionRule) -> float:
    """Empirical C of Assumption 3.2: N * max single-event contribution."""
    n_events = values.shape[0]
    max_bid = float(torch.max(auction.bids(values, rule)))
    return n_events * max_bid


def estimate_gamma(values: torch.Tensor, rule: AuctionRule,
                   key: torch.Tensor, num_probes: int = 16) -> float:
    """Empirical gamma of Assumption 3.3 (full-range version, eps = 0).

    For random activation vectors ``a`` and random deactivated campaigns
    ``c``, measure over the whole log
        max_{c'} [ sum f^{c'}(e, a - {c}) - sum f^{c'}(e, a) ] / sum f^c(e, a)
    i.e. how much total spend any one campaign can gain when c drops out,
    relative to c's own spend. In a first price auction this is <= 1.
    """
    n_campaigns = values.shape[1]
    dev = values.device
    gammas = []
    key = key.to(dev)
    for _ in range(num_probes):
        k1, k2, key = prng.split(key, 3)
        a = prng.bernoulli(k1, 0.8, (n_campaigns,))
        c = int(prng.randint(k2, (), 0, n_campaigns))
        a[c] = True
        w0, p0 = auction.resolve(values, a, rule)
        s0 = auction.spend_sums(w0, p0, n_campaigns)
        a1 = a.clone()
        a1[c] = False
        w1, p1 = auction.resolve(values, a1, rule)
        s1 = auction.spend_sums(w1, p1, n_campaigns)
        denom = float(s0[c])
        if denom <= 0:
            continue
        gain = float(torch.max(s1 - s0))
        gammas.append(max(gain, 0.0) / denom)
    return max(gammas) if gammas else 0.0
