"""The auction rule ``f(e, a)`` (port of ``repro.core.auction``).

``resolve`` returns (winner, price) per event; :func:`spend_sums` /
:func:`spend_matrix` turn that into per-campaign spends. The activation
vector is one (C,) mask for a block or a per-event (T, C) mask.

Bit-for-bit with ``repro``: bids are one float32 multiply, the winner is the
first index of the masked maximum (``torch.argmax`` and ``jnp.argmax`` both
take the lowest index on ties), and the second price is the maximum over the
other columns with the winner masked out — the pair ``lax.top_k`` returns,
without relying on ``torch.topk``'s undocumented tie order.

Invariant (paper §3): ``a^c = 0  =>  f^c(., a) = 0``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.types import AuctionRule
from repro_torch.kernels.auction_resolve.first_crossing import \
    first_crossing_cuda

NEG_INF = float("-inf")


def bids(values: torch.Tensor, rule: AuctionRule) -> torch.Tensor:
    """(T, C) values -> (T, C) bids under the rule's multipliers
    (broadcasts a stacked (S, C) rule to (S, T, C))."""
    return values * rule.multipliers[..., None, :].to(values.dtype)


def resolve(values: torch.Tensor, active: torch.Tensor,
            rule: AuctionRule) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve a block of auctions under a (C,) or (T, C) activation.

    Returns ``(winners, prices)``: winners (T,) int32 with -1 = no sale,
    prices (T,) float32. First price: the winner pays its bid. Second price:
    the winner pays max(second-highest eligible bid, reserve).
    """
    b = bids(values, rule)
    eligible = active & (b > rule.reserve)
    masked = torch.where(eligible, b, NEG_INF)
    winners = torch.argmax(masked, dim=-1, keepdim=True)
    top = masked.gather(-1, winners)[..., 0]
    sale = top > NEG_INF
    if rule.kind == "first_price":
        prices = torch.where(sale, top, 0.0)
    elif rule.kind == "second_price":
        second = masked.scatter(-1, winners, NEG_INF).amax(-1)
        second = torch.where(second > NEG_INF, second, rule.reserve)
        prices = torch.where(sale, torch.maximum(second, rule.reserve), 0.0)
    else:
        raise ValueError(f"unknown auction kind: {rule.kind}")
    winners = torch.where(sale, winners[..., 0].to(torch.int32), -1)
    return winners, prices.to(torch.float32)


def resolve_row(values_row: torch.Tensor, active: torch.Tensor,
                rule: AuctionRule):
    """Single-event resolve — the literal ``f(e, a)`` (used by the oracle)."""
    w, p = resolve(values_row[None, :], active[None, :], rule)
    return w[0], p[0]


def spend_sums(winners: torch.Tensor, prices: torch.Tensor,
               num_campaigns: int,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-campaign total spend over a block, (T,) or (S, T) winners and
    prices giving (C,) or (S, C) sums, each added in event order as XLA's
    segment sum adds on the CPU: ``index_add_`` on the CPU; on CUDA, where
    ``index_add_`` adds with atomics in an order that changes from run to
    run, the flat sum of the ``first_crossing`` kernel."""
    p = prices if weights is None else prices * weights
    lanes = winners.reshape(-1, winners.shape[-1])
    out = winners.shape[:-1] + (num_campaigns,)
    if winners.device.type == "cuda":
        _, sums = first_crossing_cuda(
            lanes.to(torch.int32).contiguous(),
            p.reshape(lanes.shape).to(torch.float32).contiguous(), None,
            num_campaigns=num_campaigns)
        return sums.reshape(out)
    w = torch.where(lanes < 0, num_campaigns, lanes).long()
    ids = w + (num_campaigns + 1) * torch.arange(
        lanes.shape[0], device=w.device)[:, None]
    sums = torch.zeros(lanes.shape[0] * (num_campaigns + 1), dtype=p.dtype,
                       device=p.device)
    sums.index_add_(0, ids.reshape(-1), p.reshape(-1))
    return sums.reshape(-1, num_campaigns + 1)[:, :num_campaigns].reshape(out)


def spend_matrix(winners: torch.Tensor, prices: torch.Tensor,
                 num_campaigns: int) -> torch.Tensor:
    """(T,) winners/prices -> (T, C) one-hot spend increments."""
    cols = torch.arange(num_campaigns, device=winners.device)
    onehot = (winners[:, None] == cols).to(prices.dtype)
    return onehot * prices[:, None]



def spend_of(winners: torch.Tensor, prices: torch.Tensor, c) -> torch.Tensor:
    """(T,) spend increments of a single campaign: its prices where it
    won, 0 elsewhere (elementwise, no sum)."""
    return torch.where(winners == c, prices, 0.0)
