"""Sequential (oracle) simulation — §4 of the paper (port of
``repro.core.sequential:23-65``).

The ground truth every parallel method is judged against: the events in
order, carrying the spend state and recomputing the activation vector before
each auction. On CUDA tensors it is one launch of the capped-scan kernel
(``csrc/capped_scan.cu``, speculative windows repaired at each cap); on
the CPU a Python loop over events, O(N) serial and slow on purpose.

:func:`naive_sampled_replay` is the paper's Fig.-1 baseline: a sorted
sample of the events replayed in order with every sale's spend rescaled by
1/rho, through the same capped scan with that scale.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import auction
from repro_torch.core.types import AuctionRule, SimResult, never_capped
from repro_torch.kernels.capped_scan import ops as scan_ops

KINDS = ("first_price", "second_price")


def second_price(kind: str) -> bool:
    """Whether a pricing ``kind`` is second price; unknown kinds raise."""
    if kind not in KINDS:
        raise ValueError(f"unknown auction kind: {kind}")
    return kind == "second_price"


def capped_sum(xs: torch.Tensor, budget) -> torch.Tensor:
    """Algorithm 1: ``min(B, sum(xs))`` for a single budget-capped
    accumulator."""
    return torch.minimum(torch.as_tensor(budget, dtype=xs.dtype,
                                         device=xs.device), xs.sum())


def sequential_replay(values: torch.Tensor, budgets: torch.Tensor,
                      rule: AuctionRule,
                      record_events: bool = True) -> SimResult:
    """Exact serial replay of Eqs. (1)-(3).

    ``a_n^c = 1{s_n^c < b^c}`` is evaluated before auction ``n+1``; the
    spend increment is applied in full even if it overshoots the budget.
    The spend state is updated in place, one float32 add per sale, as the
    reference's ``s.at[w].add(p)`` does.
    """
    if values.device.type == "cuda":
        winners, prices, s, cap = scan_ops.capped_scan(
            values, budgets, rule.multipliers, rule.reserve,
            second_price=second_price(rule.kind))
        return SimResult(final_spend=s, cap_times=cap,
                         winners=winners if record_events else None,
                         prices=prices if record_events else None)
    n_events, n_campaigns = values.shape
    device = values.device
    sentinel = never_capped(n_events)
    budgets = budgets.to(torch.float32)
    s = torch.zeros(n_campaigns, dtype=torch.float32, device=device)
    cap = torch.full((n_campaigns,), sentinel, dtype=torch.int32,
                     device=device)
    winners = torch.full((n_events,), -1, dtype=torch.int32, device=device)
    prices = torch.zeros(n_events, dtype=torch.float32, device=device)
    for n in range(n_events):
        w, p = auction.resolve_row(values[n], s < budgets, rule)
        winners[n], prices[n] = w, p
        if w >= 0:
            s[w] += p
        crossed = (s >= budgets) & (cap == sentinel)
        cap[crossed] = n + 1                         # 1-based cap time
    return SimResult(final_spend=s, cap_times=cap,
                     winners=winners if record_events else None,
                     prices=prices if record_events else None)


def inverse_rate(sample_size: int, n_events: int) -> torch.Tensor:
    """``1 / rho`` as ``repro``'s compiled replay computes it: rho = K / N
    is a constant there, and XLA's simplifier turns a division by a
    constant into a multiply by its float32 reciprocal,
    ``float32(1) / float32(rho)``."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return one / torch.tensor(sample_size / n_events, dtype=torch.float32)


def sampled_cap_times(cap_sub: torch.Tensor, sample_size: int,
                      n_events: int) -> torch.Tensor:
    """A sampled replay's 1-based cap times in its K = ``sample_size``
    events (K+1 = never) mapped to approximate times in the log of N, as
    ``repro`` maps them: ``int32(float32(cap_sub) * (1 / rho))``
    (:func:`inverse_rate`), never-capped to ``never_capped(N)``."""
    inv = inverse_rate(sample_size, n_events).to(cap_sub.device)
    approx = (cap_sub.to(torch.float32) * inv).to(torch.int32)
    return torch.where(cap_sub > sample_size, never_capped(n_events),
                       approx)


def naive_sampled_replay(values: torch.Tensor, budgets: torch.Tensor,
                         rule: AuctionRule, key: torch.Tensor,
                         sample_size: int) -> SimResult:
    """The Fig.-1 baseline the paper warns about: replay ``sample_size``
    events drawn without replacement (``prng.choice``, sorted, so in log
    order) sequentially, each sale's spend increment rescaled by ``1 / rho``
    (rho = sample_size / N; the float32 multiply of :func:`inverse_rate`),
    a cap time mapped back to the log as :func:`sampled_cap_times` does.
    Scales (the chain is rho·N long) but misplaces cap-outs. The sample is
    drawn on the values' device, whatever device ``key`` was made on. The
    sampled rows go through the capped scan with that scale: one
    ``capped_scan`` launch on CUDA, its plain loop on the CPU. No winners
    or prices are kept."""
    n_events = values.shape[0]
    # drawn where the values are: threefry is integer arithmetic and the
    # sort stable, so the card's sample is the CPU's
    key = key.to(values.device)
    idx = torch.sort(prng.choice(key, n_events, sample_size)).values
    _, _, spend, cap_sub = scan_ops.capped_scan(
        values[idx], budgets, rule.multipliers,
        rule.reserve, second_price=second_price(rule.kind),
        scale=float(inverse_rate(sample_size, n_events)))
    return SimResult(final_spend=spend,
                     cap_times=sampled_cap_times(cap_sub, sample_size,
                                                 n_events))
