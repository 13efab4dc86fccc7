"""Batched scenario sweeps: evaluate S counterfactual designs over one event
log (port of ``repro.core.sweep:66-212``).

Batched inputs are a stacked :class:`~repro_torch.core.types.AuctionRule`
(multipliers (S, C), reserve (S,), one shared ``kind``) plus (S, C)
budgets; the (N, C) valuation matrix has no scenario axis. Axis order is
(scenario, event, campaign) throughout. The Algorithm-2 sweeps are thin
wrappers over :func:`repro_torch.core.executor.execute_sweep`, the
SORT2AGGREGATE sweep over :func:`~repro_torch.core.executor.execute_s2a_sweep`.
"""
from __future__ import annotations

import torch

from repro_torch.core.executor import (DEFAULT_BLOCK_T, SweepPlan,
                                       check_batch_shapes, execute_s2a_sweep,
                                       execute_sweep, plan_for_driver)
from repro_torch.core.sequential import second_price
from repro_torch.core.types import AuctionRule, SimResult
from repro_torch.kernels.capped_scan import ops as scan_ops


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
    """S exact serial replays at once (the sweep oracle): one launch of the
    capped-scan kernel on CUDA, the batched plain version on the CPU. Each
    lane is bit for bit ``sequential_replay`` of its design."""
    check_batch_shapes(values, budgets, rules)
    winners, prices, spend, cap = scan_ops.capped_scan(
        values, budgets, rules.multipliers, rules.reserve,
        second_price=second_price(rules.kind))
    return SimResult(final_spend=spend, cap_times=cap,
                     winners=winners if record_events else None,
                     prices=prices if record_events else None)


def sweep_parallel(values: torch.Tensor, budgets: torch.Tensor,
                   rules: AuctionRule, resolve: str = "auto",
                   driver: str = "batched", skip_retired: bool = True, *,
                   mesh=None, chunks=None, scenario_chunks=None,
                   overlay=None, block_t=DEFAULT_BLOCK_T) -> SimResult:
    """Algorithm 2 over a scenario batch: one loop, serial depth
    ``max_s K_s`` rounds. ``driver`` is the placement: ``"batched"``, or
    ``"sharded"`` / ``"multihost"`` on the mesh named by ``mesh`` (a
    :class:`repro_torch.launch.mesh.SweepMeshSpec`; bit for bit
    ``"batched"`` on an aligned mesh); ``resolve`` the per-round back-end
    (``"auto"`` = the CUDA fused round on CUDA tensors, the torch path on
    CPU tensors); ``chunks`` (an int or
    :class:`~repro_torch.core.executor.ChunkSpec`) and ``scenario_chunks``
    (an int or :class:`~repro_torch.core.executor.ScenarioChunkSpec`) run
    it over event and scenario chunks, bit for bit the unchunked sweep;
    ``block_t`` is ``repro``'s tile, or ``"auto"`` for the tuner."""
    plan = plan_for_driver(driver, resolve=resolve,
                           skip_retired=skip_retired, mesh=mesh,
                           chunks=chunks, scenario_chunks=scenario_chunks,
                           block_t=block_t)
    s_hat, cap_times, _, _, _, _ = execute_sweep(values, budgets, rules,
                                                 plan, overlay=overlay)
    return SimResult(final_spend=s_hat, cap_times=cap_times)


def sweep_state_machine(values: torch.Tensor, budgets: torch.Tensor,
                        rules: AuctionRule, resolve: str = "sweep_resolve",
                        skip_retired: bool = True, *, chunks=None,
                        scenario_chunks=None, overlay=None,
                        driver: str = "batched", mesh=None,
                        block_t=DEFAULT_BLOCK_T):
    """The batched Algorithm-2 loop with its full round log exposed.

    Returns ``(s_hat (S, C), cap_times (S, C), retired (S, C+1),
    boundaries (S, C+2), num_rounds (S,), n_hat (S,))``. The default
    back-end is ``"sweep_resolve"``, the counterpart of ``repro``'s Pallas
    resolve: one resolve of all lanes per round, two canonical partials of
    its winners and prices. ``chunks``, ``scenario_chunks``, ``driver``,
    ``mesh`` and ``block_t`` as in :func:`sweep_parallel`.
    """
    plan = plan_for_driver(driver, resolve=resolve,
                           skip_retired=skip_retired, mesh=mesh,
                           chunks=chunks, scenario_chunks=scenario_chunks,
                           block_t=block_t)
    return execute_sweep(values, budgets, rules, plan, overlay=overlay)


def sweep_sort2aggregate(values: torch.Tensor, budgets: torch.Tensor,
                         rules: AuctionRule, cap_times_init=None,
                         refine_iters: int = 8, record_events: bool = False,
                         chunks=None, crossing_block: int = 4096):
    """SORT2AGGREGATE over a scenario batch: per-scenario fixed-point
    refinement of the segment history from ``cap_times_init`` ((S, C) or
    (C,); the optimistic all-active start when None), then one aggregate
    pass. Returns ``(results, consistency_gaps (S,), refine_iters_used
    (S,))``: ``gaps[s]`` is the largest |assumed - replayed| cap time in
    events, ``refine_iters_used[s]`` the iterations that moved lane s's cap
    times. Each lane's bits are its single-design
    :func:`~repro_torch.core.sort2aggregate.refine_fixed_device`'s.
    ``chunks`` (an int or :class:`~repro_torch.core.executor.ChunkSpec`)
    runs every pass chunk by chunk
    (:func:`~repro_torch.core.sort2aggregate.refine_fixed_chunked`): cap
    times and gaps bit for bit the unchunked sweep's at the same
    ``crossing_block``, ``final_spend`` the carried running total."""
    return execute_s2a_sweep(values, budgets, rules,
                             SweepPlan(placement="batched", chunks=chunks),
                             cap_times_init=cap_times_init,
                             refine_iters=refine_iters,
                             record_events=record_events,
                             crossing_block=crossing_block)
