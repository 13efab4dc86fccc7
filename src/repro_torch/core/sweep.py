"""Batched scenario sweeps: evaluate S counterfactual designs over one event
log (port of ``repro.core.sweep:66-212``).

Batched inputs are a stacked :class:`~repro_torch.core.types.AuctionRule`
(multipliers (S, C), reserve (S,), one shared ``kind``) plus (S, C)
budgets; the (N, C) valuation matrix has no scenario axis. Axis order is
(scenario, event, campaign) throughout. The Algorithm-2 sweeps are thin
wrappers over :func:`repro_torch.core.executor.execute_sweep`.
``sweep_sort2aggregate`` arrives with the SORT2AGGREGATE slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.executor import (SweepPlan, check_batch_shapes,
                                       execute_sweep, reject_unported)
from repro_torch.core.sequential import sequential_replay
from repro_torch.core.types import AuctionRule, SimResult


def stack_rules(rules) -> AuctionRule:
    """Stack single-scenario rules into one batched rule (shared ``kind``)."""
    rules = list(rules)
    if not rules:
        raise ValueError("a sweep needs at least one scenario")
    kinds = {r.kind for r in rules}
    if len(kinds) != 1:
        raise ValueError(
            f"one sweep = one pricing rule; got {kinds}. Run one sweep per "
            "kind and concatenate the tables.")
    return AuctionRule(
        multipliers=torch.stack([r.multipliers for r in rules]),
        reserve=torch.stack([r.reserve.to(torch.float32).reshape(())
                             for r in rules]),
        kind=kinds.pop())


def scenario_rule(rules: AuctionRule, s: int) -> AuctionRule:
    """Slice scenario ``s`` back out of a batched rule."""
    return AuctionRule(multipliers=rules.multipliers[s],
                       reserve=rules.reserve[s], kind=rules.kind)


def sweep_sequential(values: torch.Tensor, budgets: torch.Tensor,
                     rules: AuctionRule,
                     record_events: bool = False) -> SimResult:
    """S exact serial replays, one lane after another (the sweep oracle)."""
    check_batch_shapes(values, budgets, rules)
    outs = [sequential_replay(values, budgets[s], scenario_rule(rules, s),
                              record_events=record_events)
            for s in range(budgets.shape[0])]
    stack = lambda xs: None if xs[0] is None else torch.stack(xs)
    return SimResult(final_spend=stack([o.final_spend for o in outs]),
                     cap_times=stack([o.cap_times for o in outs]),
                     winners=stack([o.winners for o in outs]),
                     prices=stack([o.prices for o in outs]))


def sweep_parallel(values: torch.Tensor, budgets: torch.Tensor,
                   rules: AuctionRule, resolve: str = "auto",
                   driver: str = "batched", skip_retired: bool = True, *,
                   mesh=None, chunks=None, scenario_chunks=None,
                   overlay=None) -> SimResult:
    """Algorithm 2 over a scenario batch: one loop, serial depth
    ``max_s K_s`` rounds. ``driver`` is the placement (``"batched"``);
    ``resolve`` the per-round back-end (``"auto"`` = the CUDA fused round
    on CUDA tensors, the torch path on CPU tensors)."""
    reject_unported(mesh=mesh, chunks=chunks,
                    scenario_chunks=scenario_chunks)
    plan = SweepPlan(placement=driver, resolve=resolve,
                     skip_retired=skip_retired)
    s_hat, cap_times, _, _, _, _ = execute_sweep(values, budgets, rules,
                                                 plan, overlay=overlay)
    return SimResult(final_spend=s_hat, cap_times=cap_times)


def sweep_state_machine(values: torch.Tensor, budgets: torch.Tensor,
                        rules: AuctionRule, resolve: str = "auto",
                        skip_retired: bool = True, *, chunks=None,
                        scenario_chunks=None, overlay=None):
    """The batched Algorithm-2 loop with its full round log exposed.

    Returns ``(s_hat (S, C), cap_times (S, C), retired (S, C+1),
    boundaries (S, C+2), num_rounds (S,), n_hat (S,))``. (``repro``'s
    default back-end here is its Pallas resolve, which this port does not
    have; ``"auto"`` picks the fused round on CUDA, torch on the CPU.)
    """
    reject_unported(chunks=chunks, scenario_chunks=scenario_chunks)
    plan = SweepPlan(placement="batched", resolve=resolve,
                     skip_retired=skip_retired)
    return execute_sweep(values, budgets, rules, plan, overlay=overlay)
