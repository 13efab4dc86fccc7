"""High-level counterfactual API (port of
``repro.core.counterfactual:62-444``).

A :class:`CounterfactualEngine` wraps an event log (valuation matrix) and
budgets and answers "what would the day have looked like under a different
design?". A whole design space is a :class:`ScenarioGrid` — bid scalings ×
reserves × budget scalings — which :meth:`CounterfactualEngine.sweep`
evaluates in one batched program and summarises as a delta table against
the base design (scenario ``base_index``, 0 by default).

Ported estimators: SORT2AGGREGATE (``method="sort2aggregate"``, the
default of ``simulate`` and ``compare``: Algorithm 4's estimate, the
segment refinement and the aggregate pass, through the ``auction_resolve``
and ``first_crossing`` kernels on the card), Algorithm 2
(``method="parallel"``) and the exact ``"sequential"`` oracle (one
capped-scan kernel launch on the card). ``"naive_sampling"`` raises
``NotImplementedError`` naming the ROADMAP item that ports it. Keys are
:mod:`repro_torch.prng` keys; the default is ``PRNGKey(0)``, as in
``repro``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import sweep as sweep_lib
from repro_torch.core import vi as vi_lib
from repro_torch.core.executor import (SweepPlan, check_s2a_options,
                                       execute_s2a_sweep, execute_sweep,
                                       reject_unported)
from repro_torch.core.parallel import parallel_simulate
from repro_torch.core.sequential import sequential_replay
from repro_torch.core.sort2aggregate import sort2aggregate as _sort2aggregate
from repro_torch.core.types import AuctionRule, SimResult
from repro_torch.device import DeviceLike, pick_device

# estimators of repro's engine this port has not reached yet
_UNPORTED_METHODS = {
    "naive_sampling": "ROADMAP.md queue 1, item 4 (naive_sampled_replay)",
}


def _method_not_ported(method: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{where}(method={method!r}) is not ported to repro_torch yet; see "
        f"{_UNPORTED_METHODS[method]}")


@dataclasses.dataclass
class CounterfactualDelta:
    """Platform-level diff between two simulated designs."""
    revenue_base: float
    revenue_alt: float
    spend_base: torch.Tensor
    spend_alt: torch.Tensor
    cap_times_base: torch.Tensor
    cap_times_alt: torch.Tensor

    @property
    def revenue_lift(self) -> float:
        return (self.revenue_alt - self.revenue_base) / max(
            self.revenue_base, 1e-12)


@dataclasses.dataclass(frozen=True)
class ScenarioGrid:
    """A batch of S candidate designs over a shared event log: a stacked
    ``rules`` (multipliers (S, C), reserve (S,), one ``kind``), ``budgets``
    (S, C) and one label per scenario."""

    rules: AuctionRule
    budgets: torch.Tensor
    labels: Tuple[str, ...]

    def __post_init__(self):
        s = self.budgets.shape[0]
        if self.rules.multipliers.shape[0] != s or len(self.labels) != s:
            raise ValueError(
                f"inconsistent grid: {self.rules.multipliers.shape[0]} rules,"
                f" {s} budget rows, {len(self.labels)} labels")

    @property
    def num_scenarios(self) -> int:
        return self.budgets.shape[0]

    def scenario(self, s: int) -> Tuple[AuctionRule, torch.Tensor]:
        return sweep_lib.scenario_rule(self.rules, s), self.budgets[s]

    @staticmethod
    def from_scenarios(scenarios: Sequence[Tuple[AuctionRule, torch.Tensor]],
                       labels: Optional[Sequence[str]] = None
                       ) -> "ScenarioGrid":
        rules = sweep_lib.stack_rules([r for r, _ in scenarios])
        budgets = torch.stack([torch.as_tensor(b).to(torch.float32)
                               for _, b in scenarios])
        labels = tuple(labels) if labels is not None else tuple(
            f"scenario{i}" for i in range(len(scenarios)))
        return ScenarioGrid(rules=rules, budgets=budgets, labels=labels)

    @staticmethod
    def product(base_rule: AuctionRule, base_budgets: torch.Tensor,
                bid_scales: Sequence[float] = (1.0,),
                reserves: Optional[Sequence[float]] = None,
                budget_scales: Sequence[float] = (1.0,),
                kind: Optional[str] = None) -> "ScenarioGrid":
        """Cartesian design grid: bid multipliers × reserves × budget
        scalings applied to the base design; the first combination should
        be the identity so scenario 0 is the base."""
        kind = kind or base_rule.kind
        dev = base_rule.multipliers.device
        if reserves is None:
            reserves = (float(base_rule.reserve),)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
        scenarios, labels = [], []
        for bid, res, bud in itertools.product(bid_scales, reserves,
                                               budget_scales):
            rule = AuctionRule(multipliers=base_rule.multipliers * f32(bid),
                               reserve=f32(res), kind=kind)
            scenarios.append((rule, base_budgets * f32(bud)))
            labels.append(f"bid×{bid:g} res={res:g} bud×{bud:g}")
        return ScenarioGrid.from_scenarios(scenarios, labels)


@dataclasses.dataclass
class SweepResult:
    """Batched outcome of a scenario sweep + its base-relative delta
    table."""

    grid: ScenarioGrid
    results: SimResult              # batched: (S, C) spends / cap times
    n_events: int
    base_index: int = 0
    consistency_gaps: Optional[torch.Tensor] = None   # (S,), s2a sweeps
    # refine iterations that moved each scenario's cap times (s2a sweeps):
    # the warm-start quality signal
    refine_iters: Optional[torch.Tensor] = None

    def delta_table(self) -> List[dict]:
        """One row per scenario: ``revenue``, ``revenue_lift``,
        ``spend_total``, ``spend_delta``, ``num_capped`` and
        ``mean_cap_shift_events``, as in ``repro``'s table."""
        spend = self.results.final_spend.cpu().numpy().astype(np.float64)
        caps = np.minimum(self.results.cap_times.cpu().numpy().astype(
            np.int64), self.n_events + 1)
        revenue = self.results.revenue.cpu().numpy().astype(np.float64)
        base = self.base_index
        rows = []
        for s, label in enumerate(self.grid.labels):
            rows.append({
                "scenario": label,
                "revenue": float(revenue[s]),
                "revenue_lift": float(
                    (revenue[s] - revenue[base])
                    / max(revenue[base], 1e-12)),
                "spend_total": float(spend[s].sum()),
                "spend_delta": float(spend[s].sum() - spend[base].sum()),
                "num_capped": int((caps[s] <= self.n_events).sum()),
                "mean_cap_shift_events": float(
                    np.abs(caps[s] - caps[base]).mean()),
            })
        return rows

    def format_delta_table(self) -> str:
        rows = self.delta_table()
        hdr = (f"{'scenario':<28} {'revenue':>12} {'lift':>8} "
               f"{'spend':>12} {'Δspend':>10} {'capped':>6} {'Δcap':>8}")
        lines = [hdr, "-" * len(hdr)]
        for r in rows:
            lines.append(
                f"{r['scenario']:<28} {r['revenue']:>12.1f} "
                f"{r['revenue_lift']:>+7.1%} {r['spend_total']:>12.1f} "
                f"{r['spend_delta']:>+10.1f} {r['num_capped']:>6d} "
                f"{r['mean_cap_shift_events']:>8.1f}")
        return "\n".join(lines)


class CounterfactualEngine:
    """An event log (``values`` (N, C)) and budgets (C,) on one device —
    the CUDA card unless ``device`` says otherwise."""

    def __init__(self, values, budgets,
                 base_rule: Optional[AuctionRule] = None,
                 device: DeviceLike = None):
        self.device = pick_device(device)
        self.values = torch.as_tensor(values).to(self.device, torch.float32)
        self.budgets = torch.as_tensor(budgets).to(self.device,
                                                   torch.float32)
        self.n_events, self.n_campaigns = self.values.shape
        self.base_rule = base_rule or AuctionRule.first_price(
            self.n_campaigns, device=self.device)

    def simulate(self, rule: Optional[AuctionRule] = None,
                 budgets: Optional[torch.Tensor] = None,
                 method: str = "sort2aggregate",
                 key: Optional[torch.Tensor] = None,
                 **kwargs) -> SimResult:
        """One design's replay: ``"sort2aggregate"`` (``**kwargs`` going to
        :func:`~repro_torch.core.sort2aggregate.sort2aggregate`; ``key``
        defaults to ``PRNGKey(0)``), ``"parallel"`` (Algorithm 2,
        ``**kwargs`` going to
        :func:`~repro_torch.core.parallel.parallel_simulate`) or
        ``"sequential"`` (the exact oracle)."""
        rule = rule or self.base_rule
        budgets = self.budgets if budgets is None else budgets
        if method == "sequential":
            return sequential_replay(self.values, budgets, rule, **kwargs)
        if method == "parallel":
            return parallel_simulate(self.values, budgets, rule, **kwargs)
        if method == "sort2aggregate":
            key = key if key is not None else prng.PRNGKey(0)
            return _sort2aggregate(self.values, budgets, rule, key,
                                   **kwargs).result
        if method in _UNPORTED_METHODS:
            raise _method_not_ported(method, "simulate")
        raise ValueError(f"unknown method: {method}")

    def compare(self, alt_rule: AuctionRule,
                alt_budgets: Optional[torch.Tensor] = None,
                method: str = "sort2aggregate",
                key: Optional[torch.Tensor] = None,
                **kwargs) -> CounterfactualDelta:
        """The base design against ``alt_rule``/``alt_budgets``, each
        simulated with its half of a split of ``key``."""
        key = key if key is not None else prng.PRNGKey(0)
        k1, k2 = prng.split(key)
        base = self.simulate(method=method, key=k1, **kwargs)
        alt = self.simulate(rule=alt_rule, budgets=alt_budgets,
                            method=method, key=k2, **kwargs)
        return CounterfactualDelta(
            revenue_base=float(base.revenue), revenue_alt=float(alt.revenue),
            spend_base=base.final_spend, spend_alt=alt.final_spend,
            cap_times_base=base.cap_times, cap_times_alt=alt.cap_times)

    def grid(self, **kwargs) -> ScenarioGrid:
        """A :meth:`ScenarioGrid.product` around this engine's base
        design."""
        return ScenarioGrid.product(self.base_rule, self.budgets, **kwargs)

    def sweep(self, grid: ScenarioGrid, method: str = "parallel",
              base_index: int = 0, record_events: bool = False,
              resolve: str = "auto", driver: str = "batched", *,
              warm_start="base", refine_iters: int = 8,
              crossing_block: int = 4096, key: Optional[torch.Tensor] = None,
              mesh=None, chunks=None, scenario_chunks=None,
              tuned: bool = False) -> SweepResult:
        """Evaluate every scenario in ``grid`` in one batched program.

        ``method="parallel"`` runs Algorithm 2 through the executor
        (``resolve="auto"``: the CUDA fused round on the card, the torch
        path on the CPU); ``method="sequential"`` runs the exact oracle for
        all lanes at once (one capped-scan launch on the card);
        ``method="sort2aggregate"`` refines every lane's segment history
        ``refine_iters`` times and aggregates it.

        ``warm_start`` (``"sort2aggregate"`` only) seeds the refinement:
        ``"base"`` (or ``True``, the default) with the base design's cap
        times from the single-design estimator; ``"per_scenario"`` with
        Algorithm 4 run for every lane on common random numbers; ``False``
        (or None) from the all-active state. ``crossing_block`` sizes the
        first-crossing scan. The result carries ``consistency_gaps`` and
        ``refine_iters`` per scenario."""
        reject_unported(mesh=mesh, tuned=tuned)
        plan = SweepPlan(placement=driver, resolve=resolve)
        if chunks is not None and method not in ("parallel",
                                                 "sort2aggregate"):
            raise ValueError(
                "chunks= (event-chunked streaming) applies to "
                "method='parallel' and method='sort2aggregate' sweeps; "
                f"drop chunks= for method={method!r}.")
        if scenario_chunks is not None and method != "parallel":
            raise ValueError(
                "scenario_chunks= (scenario-chunked execution) currently "
                "applies to method='parallel' sweeps only; drop "
                f"scenario_chunks= for method={method!r}.")
        warm_start = {True: "base", False: None}.get(warm_start, warm_start)
        if warm_start not in (None, "base", "per_scenario"):
            raise ValueError(
                f"unknown warm_start mode: {warm_start!r} "
                "(use 'per_scenario', 'base', or False)")
        gaps = iters = None
        if method == "sort2aggregate":
            # fail fast before paying for a warm start
            check_s2a_options(plan, record_events, chunks=chunks,
                              scenario_chunks=scenario_chunks)
            caps0 = None
            if warm_start == "per_scenario":
                caps0 = self._per_scenario_warm_caps(grid, key)
            elif warm_start == "base":
                caps0 = self._base_warm_caps(grid, base_index, refine_iters,
                                             key)
            results, gaps, iters = execute_s2a_sweep(
                self.values, grid.budgets, grid.rules, plan,
                cap_times_init=caps0, refine_iters=refine_iters,
                record_events=record_events, crossing_block=crossing_block)
            return SweepResult(grid=grid, results=results,
                               n_events=self.n_events, base_index=base_index,
                               consistency_gaps=gaps, refine_iters=iters)
        reject_unported(chunks=chunks, scenario_chunks=scenario_chunks)
        if method == "parallel":
            s_hat, cap_times, _, _, _, _ = execute_sweep(
                self.values, grid.budgets, grid.rules, plan)
            results = SimResult(final_spend=s_hat, cap_times=cap_times)
        elif method == "sequential":
            results = sweep_lib.sweep_sequential(
                self.values, grid.budgets, grid.rules,
                record_events=record_events)
        elif method in _UNPORTED_METHODS:
            raise _method_not_ported(method, "sweep")
        else:
            raise ValueError(f"unknown sweep method: {method}")
        return SweepResult(grid=grid, results=results,
                           n_events=self.n_events, base_index=base_index)

    def _base_warm_caps(self, grid: ScenarioGrid, base_index: int,
                        refine_iters: int,
                        key: Optional[torch.Tensor]) -> torch.Tensor:
        """(C,) warm-start cap times from the base design (the paper's
        previous-day trick): the single-design SORT2AGGREGATE of scenario
        ``base_index``."""
        base_rule, base_budgets = grid.scenario(base_index)
        key = key if key is not None else prng.PRNGKey(0)
        base = _sort2aggregate(self.values, base_budgets, base_rule, key,
                               refine_iters=refine_iters)
        return base.result.cap_times

    def _per_scenario_warm_caps(self, grid: ScenarioGrid,
                                key: Optional[torch.Tensor],
                                sample_rate: float = 0.1,
                                vi_iters: int = 80,
                                vi_batch_size: int = 64,
                                vi_eta_decay: float = 0.05) -> torch.Tensor:
        """(S, C) warm-start cap times: Algorithm 4 for every scenario on
        the same sample and draws (common random numbers), each under its
        own design, with a larger VI budget than the single-design default
        (10% sample, 80 epochs, decayed steps), as in ``repro``."""
        sample_size = max(int(round(self.n_events * sample_rate)),
                          vi_batch_size)
        est = vi_lib.estimate_pi_sweep(
            self.values, grid.budgets, grid.rules,
            key if key is not None else prng.PRNGKey(0),
            sample_size=sample_size, num_iters=vi_iters,
            batch_size=vi_batch_size, eta_decay=vi_eta_decay)
        return vi_lib.pi_to_cap_times(est.pi, self.n_events)
