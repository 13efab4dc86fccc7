"""High-level counterfactual API (port of
``repro.core.counterfactual:62-444``).

A :class:`CounterfactualEngine` wraps an event log (valuation matrix) and
budgets and answers "what would the day have looked like under a different
design?". A whole design space is a :class:`ScenarioGrid` — bid scalings ×
reserves × budget scalings — which :meth:`CounterfactualEngine.sweep`
evaluates in one batched program and summarises as a delta table against
the base design (scenario ``base_index``, 0 by default).

Ported estimators: ``sweep(method="parallel")`` (Algorithm 2) and the
``"sequential"`` oracle. The others raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import sweep as sweep_lib
from repro_torch.core.executor import (SweepPlan, execute_sweep,
                                       reject_unported)
from repro_torch.core.sequential import sequential_replay
from repro_torch.core.types import AuctionRule, SimResult
from repro_torch.device import DeviceLike, pick_device

# estimators of repro's engine this port has not reached yet
_UNPORTED_METHODS = {
    "sort2aggregate": "ROADMAP.md queue 1, item 4 (Algorithms 3-4)",
    "naive_sampling": "ROADMAP.md queue 1, item 4 (Algorithms 3-4)",
    "parallel": "ROADMAP.md queue 1, item 2 (core/parallel.py)",
}


def _method_not_ported(method: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{where}(method={method!r}) is not ported to repro_torch yet; see "
        f"{_UNPORTED_METHODS[method]}")


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
                 method: str = "sort2aggregate", **kwargs) -> SimResult:
        """One design's replay. Ported: ``method="sequential"``."""
        rule = rule or self.base_rule
        budgets = self.budgets if budgets is None else budgets
        if method == "sequential":
            return sequential_replay(self.values, budgets, rule, **kwargs)
        if method in _UNPORTED_METHODS:
            raise _method_not_ported(method, "simulate")
        raise ValueError(f"unknown method: {method}")

    def grid(self, **kwargs) -> ScenarioGrid:
        """A :meth:`ScenarioGrid.product` around this engine's base
        design."""
        return ScenarioGrid.product(self.base_rule, self.budgets, **kwargs)

    def sweep(self, grid: ScenarioGrid, method: str = "parallel",
              base_index: int = 0, record_events: bool = False,
              resolve: str = "auto", driver: str = "batched", *,
              mesh=None, chunks=None, scenario_chunks=None,
              tuned: bool = False) -> SweepResult:
        """Evaluate every scenario in ``grid`` in one batched program.

        ``method="parallel"`` runs Algorithm 2 through the executor
        (``resolve="auto"``: the CUDA fused round on the card, the torch
        path on the CPU); ``method="sequential"`` runs the exact oracle one
        lane after another (validation only)."""
        reject_unported(mesh=mesh, chunks=chunks,
                        scenario_chunks=scenario_chunks, tuned=tuned)
        plan = SweepPlan(placement=driver, resolve=resolve)
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
