"""Algorithm 3 — SORT2AGGREGATE, the production counterfactual estimator
(port of ``repro.core.sort2aggregate``).

* **Sort** — estimate the cap-out times by Algorithm 4
  (:mod:`repro_torch.core.vi`) or take a warm start;
* **Refine** — fixed-point iteration on the segment history: replay under
  the current activation masks, read off the actual budget crossings,
  rebuild the segments, repeat;
* **Aggregate** — one final replay under the converged segments.

Each replay is one pass of :func:`repro_torch.core.segments.aggregate`: a
resolve under each event's segment mask (on CUDA the ``segment_resolve``
kernel, one launch for every lane of a pass) and the flat totals and first
crossings in ``repro``'s float order (the ``first_crossing`` kernel on
CUDA), so on the CPU every cap time, gap and spend is ``repro``'s bit for
bit, and the card gives the CPU's bits.

The event-chunked spine :func:`refine_fixed_chunked` runs every pass as a
loop over chunks of the log, carrying each lane's running spend and cap
times from one chunk to the next (on CUDA one ``segment_resolve`` launch
and one ``first_crossing`` call a chunk, for every lane).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import segments as seg_lib
from repro_torch.core import vi as vi_lib
from repro_torch.core.types import AuctionRule, Segments, SimResult
from repro_torch.kernels.auction_resolve import ops as resolve_ops


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
        # the replay's cap times only (aggregate's, without the flat sums)
        winners, prices = seg_lib.resolve_segments(values, segs, rule)
        new_caps = seg_lib.first_crossing_times(
            winners, prices, budgets, values.shape[1]).cpu().numpy().astype(
                np.int64)
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
                  crossing_block: int, spends: bool = True):
    """One replay of S lanes (caps (S, C)) under their segment histories:
    every lane resolved under its own segment table (one
    ``segment_resolve`` launch on CUDA), then one crossing pass for all
    lanes, with the flat sums unless ``spends=False`` (a refine pass, which
    reads the cap times only). Returns ``(spend (S, C) or None, cap times
    (S, C), winners (S, N), prices (S, N))``; lanes never exchange data, so
    each lane's bits are its single-lane
    :func:`~repro_torch.core.segments.aggregate`'s."""
    n_events, n_campaigns = values.shape
    segs = Segments.from_cap_times(caps, n_events)
    winners, prices = resolve_ops.segment_resolve(
        values, rules.multipliers, rules.reserve, segs.boundaries,
        segs.masks, second_price=rules.kind == "second_price")
    if not spends:
        return None, seg_lib.first_crossing_times(
            winners, prices, budgets, n_campaigns, crossing_block), \
            winners, prices
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
                                     crossing_block=crossing_block,
                                     spends=False)
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


def _replay_chunked(values: torch.Tensor, caps: torch.Tensor,
                    budgets: torch.Tensor, rules: AuctionRule, *,
                    chunk_events: int, crossing_block: int):
    """One replay of S lanes under their segment histories, chunk by
    chunk: each chunk's rows resolved for every lane at the chunk's global
    offset (one ``segment_resolve`` launch on CUDA), then one crossing
    call for every lane that carries the running spend and the cap times
    from the previous chunk (:func:`~repro_torch.core.segments.
    crossing_carry`). Returns ``(running spend (S, C), cap times (S, C))``
    after the last chunk."""
    n_events, n_campaigns = values.shape
    sentinel = n_events + 1
    segs = Segments.from_cap_times(caps, n_events)
    dev = values.device
    s0 = torch.zeros(caps.shape, dtype=torch.float32, device=dev)
    cap = torch.full(caps.shape, sentinel, dtype=torch.int32, device=dev)
    b = budgets.to(torch.float32)
    for offset in range(0, n_events, chunk_events):
        winners, prices = resolve_ops.segment_resolve(
            values[offset:offset + chunk_events], rules.multipliers,
            rules.reserve, segs.boundaries, segs.masks,
            second_price=rules.kind == "second_price", offset=offset)
        s0, cap = seg_lib.crossing_carry(
            winners, prices, b, n_campaigns, crossing_block, s0=s0, cap=cap,
            offset=offset, n_global=n_events)
    return s0, torch.clamp(cap, max=sentinel)


def refine_fixed_chunked(values: torch.Tensor, budgets: torch.Tensor,
                         rules: AuctionRule, cap_times0: torch.Tensor, *,
                         chunk_events: int, refine_iters: int = 8,
                         crossing_block: int = 4096):
    """:func:`refine_fixed_lanes` with every replay pass run chunk by
    chunk over the log (``repro``'s ``refine_fixed_chunked``, all S lanes
    at once): the per-event winners and prices exist for one chunk at a
    time, (S, chunk_events), not (S, N).

    Chunks must hold whole crossing blocks and tile the log (``repro``'s
    texts). Every chunk then runs the same blockwise crossing steps as the
    unchunked scan with the same ``crossing_block``, so the cap times, the
    gaps and the iterations are bit for bit :func:`refine_fixed_lanes`'s;
    ``final_spend`` is the carried running total after the last chunk,
    bit for bit the same at every aligned chunk size and equal to the
    unchunked flat sum up to float association. Returns ``(SimResult,
    gaps (S,) float32, iters_used (S,) int32)``."""
    n_events = values.shape[0]
    if chunk_events % crossing_block != 0:
        raise ValueError(
            f"chunk/grid misalignment: chunks of {chunk_events} events do "
            f"not hold whole crossing blocks of {crossing_block} "
            "(first_crossing_times' blockwise scan); chunks must cover "
            "whole blocks for the bit-for-bit crossing contract. Use a "
            f"chunk size that is a multiple of {crossing_block}, or pass a "
            "crossing_block= that divides your chunk (both paths must use "
            "the same block).")
    if n_events % chunk_events != 0:
        raise ValueError(
            f"ragged chunk: {n_events} events do not divide into chunks of "
            f"{chunk_events} (remainder {n_events % chunk_events}). Pad the "
            "event log so every chunk is full, pick a chunk size that "
            "divides the event count, or drop chunks=.")
    sentinel = n_events + 1
    caps = torch.clamp(cap_times0.to(torch.int32), max=sentinel)
    moved = torch.zeros(caps.shape[0], dtype=torch.int32, device=caps.device)
    kw = dict(chunk_events=chunk_events, crossing_block=crossing_block)
    for _ in range(refine_iters):
        _, new = _replay_chunked(values, caps, budgets, rules, **kw)
        moved = moved + (new != caps).any(-1).to(torch.int32)
        caps = new
    spend, cap = _replay_chunked(values, caps, budgets, rules, **kw)
    gap = (cap - caps).abs().to(torch.float32).amax(-1)
    final = SimResult(final_spend=spend, cap_times=cap, winners=None,
                      prices=None,
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
