"""Sequential (oracle) simulation — §4 of the paper (port of
``repro.core.sequential:23-65``).

The ground truth every parallel method is judged against: the events in
order, carrying the spend state and recomputing the activation vector before
each auction. On CUDA tensors it is one launch of the capped-scan kernel
(``csrc/capped_scan.cu``, a warp walking the events); on the CPU a Python
loop over events, O(N) serial and slow on purpose. ``naive_sampled_replay``
arrives with the SORT2AGGREGATE slice.
"""
from __future__ import annotations

import torch

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
