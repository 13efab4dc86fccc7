"""Algorithm 2 — parallel simulation of one design (port of
``repro.core.parallel:61-272``).

The driver alternates between two parallel computations over the event log
and O(C) bookkeeping per round:

1. the expected spend speed of every campaign under the current activation
   set, a masked mean over the remaining events;
2. the exact spends of the block that runs until the next predicted
   cap-out, a masked sum.

Each round retires one campaign, so the serial depth is K+1 rounds, not N.

Two drivers run the same loop with the same float32 arithmetic, so their
``final_spend``/``cap_times`` agree bit for bit:

* ``driver="device"`` — :func:`parallel_state_machine`, the executor's
  batched program at S=1 (``placement="device"``) with any resolve
  back-end, then the segment history rebuilt from its round log;
* ``driver="host"`` — the reference host loop in numpy, over
  ``rate_fn``/``block_fn`` closures (:func:`repro_torch.core.segments.
  masked_rate` / ``block_spend_sums`` by default); passing either closure
  selects it under ``driver="auto"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import segments as seg_lib
from repro_torch.core.executor import (SweepPlan, check_sim_driver,
                                       execute_sweep)
from repro_torch.core.types import (AuctionRule, Segments, SimResult,
                                    never_capped)


@dataclasses.dataclass
class ParallelSimTrace:
    """Per-round log of the Algorithm-2 driver."""
    capped_order: list
    boundaries: list
    num_rounds: int = 0


def parallel_simulate(values: torch.Tensor, budgets: torch.Tensor,
                      rule: AuctionRule, *,
                      rate_fn: Optional[Callable] = None,
                      block_fn: Optional[Callable] = None,
                      record_events: bool = False,
                      return_trace: bool = False, driver: str = "auto",
                      resolve: str = "torch"):
    """Run Algorithm 2 for one design. Returns a :class:`SimResult` with
    its ``segments`` (and a :class:`ParallelSimTrace` if
    ``return_trace``).

    ``driver`` is ``"device"`` (the executor's loop), ``"host"`` (the
    reference loop) or ``"auto"`` (host when custom ``rate_fn``/``block_fn``
    closures are given, else device). ``resolve`` is the device driver's
    back-end: ``"torch"`` (the default, ``repro``'s ``"jnp"``),
    ``"sweep_resolve"``, ``"fused"`` or ``"auto"``. ``record_events``
    replays the segment history once more
    (:func:`~repro_torch.core.segments.aggregate`) for per-event winners and
    prices.
    """
    check_sim_driver(driver)
    if driver == "auto":
        driver = "host" if (rate_fn is not None or block_fn is not None) \
            else "device"
    if driver == "device":
        if rate_fn is not None or block_fn is not None:
            raise ValueError("custom rate_fn/block_fn need driver='host'")
        out = _simulate_device(values, budgets, rule, resolve=resolve,
                               return_trace=return_trace)
    else:
        out = _simulate_host(values, budgets, rule, rate_fn=rate_fn,
                             block_fn=block_fn, return_trace=return_trace)
    if not record_events:
        return out
    result, trace = out if return_trace else (out, None)
    replay = seg_lib.aggregate(values, result.segments, budgets, rule)
    result = dataclasses.replace(result, winners=replay.winners,
                                 prices=replay.prices)
    return (result, trace) if return_trace else result


def _segments(boundaries, masks, n_campaigns: int, device) -> Segments:
    masks = np.stack(masks) if masks else np.ones((1, n_campaigns), bool)
    return Segments(
        boundaries=torch.tensor(boundaries, dtype=torch.int32, device=device),
        masks=torch.from_numpy(masks).to(device))


# ---------------------------------------------------------------------------
# Host driver (reference)
# ---------------------------------------------------------------------------

def _simulate_host(values, budgets, rule, *, rate_fn, block_fn,
                   return_trace):
    dev = values.device
    rate_fn = rate_fn or (
        lambda a, lo: seg_lib.masked_rate(values, a, rule, lo))
    block_fn = block_fn or (
        lambda a, lo, hi: seg_lib.block_spend_sums(values, a, rule, lo, hi))
    as_np = lambda t: np.asarray(torch.as_tensor(t).cpu(), np.float32)
    on_dev = lambda x: torch.as_tensor(x, device=dev)

    n_events, n_campaigns = values.shape
    s_hat = np.zeros((n_campaigns,), np.float32)
    b = as_np(budgets)
    active = np.ones((n_campaigns,), bool)
    cap_times = np.full((n_campaigns,), never_capped(n_events), np.int64)
    n_hat = 0
    boundaries = [0]
    masks = []
    trace = ParallelSimTrace(capped_order=[], boundaries=[0])

    for _ in range(n_campaigns + 1):
        if n_hat >= n_events or not active.any():
            break
        trace.num_rounds += 1
        rates = as_np(rate_fn(on_dev(active), on_dev(n_hat)))
        with np.errstate(divide="ignore", invalid="ignore"):
            ttl = np.where(active & (rates > 0), (b - s_hat) / rates,
                           np.float32(np.inf))
        ttl = np.where(ttl < 0, np.float32(0.0), ttl)  # past budget: retire
        c_next = int(np.argmin(ttl))
        if np.isinf(ttl[c_next]):
            # nobody else caps: one last block to N, everyone kept
            s_hat += as_np(block_fn(on_dev(active), on_dev(n_hat),
                                    on_dev(n_events)))
            masks.append(active.copy())
            boundaries.append(n_events)
            n_hat = n_events
            break
        n_next = min(n_hat + int(np.floor(ttl[c_next])), n_events)
        s_hat += as_np(block_fn(on_dev(active), on_dev(n_hat),
                                on_dev(n_next)))
        masks.append(active.copy())
        boundaries.append(n_next)
        cap_times[c_next] = min(n_next + 1, never_capped(n_events))
        trace.capped_order.append(c_next)
        trace.boundaries.append(n_next)
        active[c_next] = False
        n_hat = n_next

    if n_hat < n_events:   # the active set emptied before the log ran out
        masks.append(active.copy())
        boundaries.append(n_events)

    result = SimResult(
        final_spend=torch.from_numpy(s_hat).to(dev),
        cap_times=torch.from_numpy(cap_times.astype(np.int32)).to(dev),
        segments=_segments(boundaries, masks, n_campaigns, dev))
    return (result, trace) if return_trace else result


# ---------------------------------------------------------------------------
# Device driver: the executor's batched loop on a single lane
# ---------------------------------------------------------------------------

def parallel_state_machine(values: torch.Tensor, budgets: torch.Tensor,
                           rule: AuctionRule, resolve: str = "torch"):
    """The Algorithm-2 loop of one design as the executor's
    ``placement="device"`` program (the batched program at S=1, so the same
    arithmetic as a scenario sweep). Returns ``(s_hat (C,), cap_times (C,),
    retired (C+1,), boundaries (C+2,), num_rounds (), n_hat ())``:
    ``retired[j]`` is the campaign retired after round j (-1 for a last
    round in which nobody caps) and ``boundaries[j+1]`` the end of round
    j's block."""
    return execute_sweep(values, budgets, rule,
                         SweepPlan(placement="device", resolve=resolve))


def _simulate_device(values, budgets, rule, *, resolve, return_trace):
    n_events, n_campaigns = values.shape
    s_hat, cap_times, retired, bnds, num_rounds, _ = parallel_state_machine(
        values, budgets, rule, resolve=resolve)
    retired, bnds = retired.cpu().numpy(), bnds.cpu().numpy()
    num_rounds = int(num_rounds)

    # the host driver's segment history, rebuilt from the round log
    masks, bnd_list = [], [0]
    mask = np.ones((n_campaigns,), bool)
    for j in range(num_rounds):
        masks.append(mask.copy())
        bnd_list.append(int(bnds[j + 1]))
        if retired[j] >= 0:
            mask[retired[j]] = False
    if bnd_list[-1] < n_events:   # the active set emptied before the end
        masks.append(mask.copy())
        bnd_list.append(n_events)
    result = SimResult(
        final_spend=s_hat, cap_times=cap_times,
        segments=_segments(bnd_list, masks, n_campaigns, values.device))
    if return_trace:
        capping = [j for j in range(num_rounds) if retired[j] >= 0]
        trace = ParallelSimTrace(
            capped_order=[int(retired[j]) for j in capping],
            boundaries=[0] + [bnd_list[j + 1] for j in capping],
            num_rounds=num_rounds)
        return result, trace
    return result
