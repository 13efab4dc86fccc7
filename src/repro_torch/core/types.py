"""Core datatypes for burnout-variable simulation (port of
``repro.core.types``).

The model is the paper's §3: a dense valuation matrix ``values[n, c]`` over
N events and C campaigns, budgets ``b`` with spend state ``s`` (the burnout
variables ``a_n^c = 1{s_n^c < b^c}``), and an auction rule ``f(e, a)``
(:mod:`repro_torch.core.auction`). Where ``repro`` registers pytrees, the
port keeps frozen dataclasses holding tensors; the pricing ``kind`` is a
plain string.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import DeviceLike, pick_device


def never_capped(n_events: int) -> int:
    """Sentinel cap time: one past the last (1-based) event index."""
    return n_events + 1


@dataclasses.dataclass(frozen=True)
class AuctionRule:
    """The platform design ``f``: pricing rule + per-campaign multipliers.

    ``multipliers`` is (C,) for one design or (S, C) for a stacked scenario
    batch, ``reserve`` () or (S,). ``kind`` is ``"first_price"`` or
    ``"second_price"`` and is shared by a whole batch.
    """

    multipliers: torch.Tensor
    reserve: torch.Tensor
    kind: str = "first_price"

    @staticmethod
    def _unit(kind: str, num_campaigns: int, reserve: float,
              device: DeviceLike) -> "AuctionRule":
        dev = pick_device(device)
        return AuctionRule(
            multipliers=torch.ones(num_campaigns, dtype=torch.float32,
                                   device=dev),
            reserve=torch.tensor(reserve, dtype=torch.float32, device=dev),
            kind=kind)

    @staticmethod
    def first_price(num_campaigns: int, reserve: float = 0.0, *,
                    device: DeviceLike = None) -> "AuctionRule":
        return AuctionRule._unit("first_price", num_campaigns, reserve,
                                 device)

    @staticmethod
    def second_price(num_campaigns: int, reserve: float = 0.0, *,
                     device: DeviceLike = None) -> "AuctionRule":
        return AuctionRule._unit("second_price", num_campaigns, reserve,
                                 device)

    def with_multiplier(self, c: int, m: float) -> "AuctionRule":
        mult = self.multipliers.clone()
        mult[c] = torch.tensor(m, dtype=torch.float32)
        return dataclasses.replace(self, multipliers=mult)

    def scaled(self, m) -> "AuctionRule":
        return dataclasses.replace(
            self, multipliers=self.multipliers * torch.as_tensor(
                m, dtype=torch.float32, device=self.multipliers.device))


@dataclasses.dataclass(frozen=True)
class Segments:
    """A piecewise-constant activation history.

    Events in ``[boundaries[j], boundaries[j+1])`` (0-indexed) are resolved
    under activation mask ``masks[j]``. Once the segments are known, every
    per-event quantity is a parallel map and every total a parallel reduce.
    """

    boundaries: torch.Tensor   # (K+2,) int32, [0] = 0, [-1] = N
    masks: torch.Tensor        # (K+1, C) bool, the mask of each segment

    @property
    def num_segments(self) -> int:
        return self.masks.shape[0]

    def seg_ids(self, n_events: int) -> torch.Tensor:
        """Segment id of each event index (0-based), int32."""
        idx = torch.arange(n_events, dtype=torch.int32,
                           device=self.boundaries.device)
        return torch.searchsorted(self.boundaries[1:-1].contiguous(), idx,
                                  right=True).to(torch.int32)

    @staticmethod
    def trivial(n_events: int, num_campaigns: int,
                device: DeviceLike = None) -> "Segments":
        dev = pick_device(device)
        return Segments(
            boundaries=torch.tensor([0, n_events], dtype=torch.int32,
                                    device=dev),
            masks=torch.ones((1, num_campaigns), dtype=torch.bool,
                             device=dev))

    @staticmethod
    def from_cap_times(cap_times: torch.Tensor, n_events: int) -> "Segments":
        """Build segments from per-campaign cap times (C,), or a batch
        (..., C) giving batched fields.

        ``cap_times[c]`` is the 1-based event index after which campaign
        ``c`` is inactive; ``> n_events`` means it never caps. There are
        always C+1 segments: campaigns capping at the same time keep a
        duplicate boundary (the earlier segment is empty), and a
        never-capped campaign's boundary is clipped to N (an empty segment
        at the end). ``masks[j]`` holds the campaigns whose cap time is
        strictly greater than the segment's start.
        """
        cap = cap_times.to(torch.int64)
        times = torch.where(cap <= n_events, cap, n_events + 1)
        ends = torch.clamp(torch.sort(times, dim=-1).values, max=n_events)
        edge = torch.zeros(cap.shape[:-1] + (1,), dtype=torch.int64,
                           device=cap.device)
        bnds = torch.cat([edge, ends, edge + n_events], dim=-1)
        masks = cap[..., None, :] > bnds[..., :-1, None]
        return Segments(boundaries=bnds.to(torch.int32), masks=masks)


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Outcome of a (counterfactual) replay.

    Sweeps return the batched form with a leading (S,) scenario axis on
    every field; ``revenue``/``num_capped`` reduce over the trailing axis.
    """

    final_spend: torch.Tensor               # (C,) or (S, C) float32
    cap_times: torch.Tensor                 # (C,) or (S, C) int32, 1-based
    winners: Optional[torch.Tensor] = None  # (N,) int32, -1 = no sale
    prices: Optional[torch.Tensor] = None   # (N,) float32
    segments: Optional[Segments] = None     # Algorithm 2's activation history

    @property
    def revenue(self) -> torch.Tensor:
        if self.prices is None:
            return self.final_spend.sum(-1)
        start = 1 if self.batch_size is not None else 0
        return self.prices.sum(tuple(range(start, self.prices.ndim)))

    def num_capped(self, n_events: int) -> torch.Tensor:
        return (self.cap_times <= n_events).sum(-1)

    @property
    def batch_size(self) -> Optional[int]:
        """Number of scenarios if batched, else None."""
        return self.final_spend.shape[0] if self.final_spend.ndim == 2 \
            else None

    def scenario(self, s: int) -> "SimResult":
        """Slice scenario ``s`` out of a batched result."""
        if self.batch_size is None:
            raise ValueError("not a batched SimResult")
        take = lambda x: None if x is None else x[s]
        return SimResult(final_spend=self.final_spend[s],
                         cap_times=self.cap_times[s],
                         winners=take(self.winners), prices=take(self.prices))
