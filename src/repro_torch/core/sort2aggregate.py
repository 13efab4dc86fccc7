"""Algorithm 3 — SORT2AGGREGATE, the production counterfactual estimator
(port of ``repro.core.sort2aggregate``).

* **Sort** — estimate the cap-out times by Algorithm 4
  (:mod:`repro_torch.core.vi`) or take a warm start;
* **Refine** — fixed-point iteration on the segment history: replay under
  the current activation masks, read off the actual budget crossings,
  rebuild the segments, repeat;
* **Aggregate** — one final replay under the converged segments.

Each replay is one pass of :func:`repro_torch.core.segments.aggregate`: a
resolve under per-event masks (the ``auction_resolve`` kernel on CUDA) and
the flat totals and first crossings in ``repro``'s float order (the
``first_crossing`` kernel on CUDA), so on the CPU every cap time, gap and
spend is ``repro``'s bit for bit, and the card gives the CPU's bits.

The event-chunked spine ``refine_fixed_chunked`` waits for the chunk axis
(ROADMAP.md queue 1, item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import segments as seg_lib
from repro_torch.core import vi as vi_lib
from repro_torch.core.types import AuctionRule, Segments, SimResult


@dataclasses.dataclass
class Sort2AggregateResult:
    result: SimResult
    pi: Optional[torch.Tensor]      # step-1 estimate (None if warm-started)
    refine_iters_used: int
    converged: bool
    consistency_gap: float          # max |assumed cap - replayed cap| (events)


def refine_segments(values: torch.Tensor, budgets: torch.Tensor,
                    rule: AuctionRule, cap_times0: torch.Tensor, *,
                    max_iters: int = 8):
    """Step 2: fixed-point refinement of cap times under segment replay,
    on the host. The discrete map can 2-cycle near ties, so a revisited
    state is damped (the cycle endpoints averaged); the returned state is
    the one with the smallest self-consistency gap seen. Returns ``(cap
    times (C,) int32, iterations, converged)``."""
    n_events = values.shape[0]
    dev = values.device
    caps = cap_times0.cpu().numpy().astype(np.int64)
    seen: set = set()
    best_caps, best_gap = caps, np.inf
    converged = False
    it = 0
    for it in range(max_iters):
        segs = Segments.from_cap_times(
            torch.from_numpy(caps.astype(np.int32)).to(dev), n_events)
        replay = seg_lib.aggregate(values, segs, budgets, rule,
                                   record_events=False)
        new_caps = replay.cap_times.cpu().numpy().astype(np.int64)
        gap = int(np.max(np.abs(np.minimum(new_caps, n_events + 1)
                                - np.minimum(caps, n_events + 1))))
        if gap < best_gap:
            best_caps, best_gap = caps, gap
        if gap == 0:
            converged = True
            break
        state = new_caps.tobytes()
        if state in seen:                      # cycle: damp and continue
            new_caps = (caps + new_caps) // 2
            seen.clear()
        seen.add(state)
        caps = new_caps
    return (torch.from_numpy(best_caps.astype(np.int32)).to(dev), it + 1,
            converged)


def _replay_lanes(values: torch.Tensor, caps: torch.Tensor,
                  budgets: torch.Tensor, rules: AuctionRule, *,
                  crossing_block: int):
    """One replay of S lanes (caps (S, C)) under their segment histories:
    each lane resolved on its own (N, C) mask, then one crossing pass for
    all lanes. Returns ``(spend (S, C), cap times (S, C), winners (S, N),
    prices (S, N))``; lanes never exchange data, so each lane's bits are
    its single-lane :func:`~repro_torch.core.segments.aggregate`'s."""
    n_events, n_campaigns = values.shape
    segs = Segments.from_cap_times(caps, n_events)
    resolved = [seg_lib.resolve_segments(
        values, Segments(boundaries=segs.boundaries[s], masks=segs.masks[s]),
        AuctionRule(multipliers=rules.multipliers[s],
                    reserve=rules.reserve[s], kind=rules.kind))
        for s in range(caps.shape[0])]
    winners = torch.stack([w for w, _ in resolved])
    prices = torch.stack([p for _, p in resolved])
    spend, cap = seg_lib.crossing_and_spend(winners, prices, budgets,
                                            n_campaigns, crossing_block)
    return spend, cap, winners, prices


def refine_fixed_lanes(values: torch.Tensor, budgets: torch.Tensor,
                       rules: AuctionRule, cap_times0: torch.Tensor, *,
                       refine_iters: int = 8, record_events: bool = False,
                       crossing_block: int = 4096):
    """:func:`refine_fixed_device` for S lanes at once (budgets and
    ``cap_times0`` (S, C), a stacked rule): each iteration replays every
    lane (:func:`_replay_lanes`). Returns ``(SimResult with (S, ...)
    fields, gaps (S,) float32, iters_used (S,) int32)``."""
    n_events = values.shape[0]
    sentinel = n_events + 1
    caps = torch.clamp(cap_times0.to(torch.int32), max=sentinel)
    moved = torch.zeros(caps.shape[0], dtype=torch.int32, device=caps.device)
    for _ in range(refine_iters):
        _, new, _, _ = _replay_lanes(values, caps, budgets, rules,
                                     crossing_block=crossing_block)
        new = torch.clamp(new, max=sentinel)
        moved = moved + (new != caps).any(-1).to(torch.int32)
        caps = new
    spend, cap, winners, prices = _replay_lanes(
        values, caps, budgets, rules, crossing_block=crossing_block)
    gap = (torch.clamp(cap, max=sentinel) - caps).abs().to(
        torch.float32).amax(-1)
    final = SimResult(final_spend=spend, cap_times=cap,
                      winners=winners if record_events else None,
                      prices=prices if record_events else None,
                      segments=Segments.from_cap_times(caps, n_events))
    return final, gap, moved


def refine_fixed_device(values: torch.Tensor, budgets: torch.Tensor,
                        rule: AuctionRule, cap_times0: torch.Tensor, *,
                        refine_iters: int = 8, record_events: bool = False,
                        crossing_block: int = 4096):
    """Step 2 + Step 3 for one design: a fixed number of fixed-point
    iterations on the cap times (no cycle detection) then the aggregate
    pass. Returns ``(SimResult, consistency_gap () float32, iters_used ()
    int32)``, ``iters_used`` counting the iterations that moved the cap
    times."""
    rules = AuctionRule(multipliers=rule.multipliers[None, :],
                        reserve=rule.reserve.reshape(1), kind=rule.kind)
    final, gap, moved = refine_fixed_lanes(
        values, budgets[None, :], rules, cap_times0.reshape(1, -1),
        refine_iters=refine_iters, record_events=record_events,
        crossing_block=crossing_block)
    take = lambda x: None if x is None else x[0]
    segs = final.segments
    return SimResult(
        final_spend=final.final_spend[0], cap_times=final.cap_times[0],
        winners=take(final.winners), prices=take(final.prices),
        segments=Segments(boundaries=segs.boundaries[0],
                          masks=segs.masks[0])), gap[0], moved[0]


def sort2aggregate(values: torch.Tensor, budgets: torch.Tensor,
                   rule: AuctionRule, key: Optional[torch.Tensor] = None, *,
                   cap_times_init: Optional[torch.Tensor] = None,
                   sample_rate: float = 0.01, vi_iters: int = 20,
                   vi_eta: float = 0.5, vi_eta_decay: float = 0.0,
                   vi_batch_size: int = 64, refine_iters: int = 8,
                   record_events: bool = False) -> Sort2AggregateResult:
    """SORT2AGGREGATE for one design: Algorithm 4 on a ``sample_rate``
    sample (or ``cap_times_init``), the host refinement
    (:func:`refine_segments`), then the aggregate pass."""
    n_events = values.shape[0]
    pi = None
    if cap_times_init is None:
        if key is None:
            raise ValueError("need a PRNG key when no warm start is given")
        sample_size = max(int(round(n_events * sample_rate)), vi_batch_size)
        est = vi_lib.estimate_pi(
            values, budgets, rule, key, sample_size=sample_size,
            num_iters=vi_iters, eta=vi_eta, eta_decay=vi_eta_decay,
            batch_size=vi_batch_size)
        pi = est.pi
        cap_times = vi_lib.pi_to_cap_times(pi, n_events)
    else:
        cap_times = torch.as_tensor(cap_times_init).to(values.device,
                                                       torch.int32)
    iters_used, converged = 0, refine_iters == 0
    if refine_iters > 0:
        cap_times, iters_used, converged = refine_segments(
            values, budgets, rule, cap_times, max_iters=refine_iters)
    segs = Segments.from_cap_times(cap_times, n_events)
    final = seg_lib.aggregate(values, segs, budgets, rule,
                              record_events=record_events)
    sentinel = n_events + 1
    gap = float((torch.clamp(final.cap_times, max=sentinel).to(torch.float32)
                 - torch.clamp(cap_times, max=sentinel).to(torch.float32))
                .abs().max())
    return Sort2AggregateResult(result=final, pi=pi,
                                refine_iters_used=iters_used,
                                converged=converged, consistency_gap=gap)
