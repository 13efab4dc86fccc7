"""High-level counterfactual API (port of
``repro.core.counterfactual:62-444``).

A :class:`CounterfactualEngine` wraps an event log (valuation matrix) and
budgets and answers "what would the day have looked like under a different
design?". A whole design space is a :class:`ScenarioGrid` — bid scalings ×
reserves × budget scalings — which :meth:`CounterfactualEngine.sweep`
evaluates in one batched program and summarises as a delta table against
the base design (scenario ``base_index``, 0 by default).

Estimators: SORT2AGGREGATE (``method="sort2aggregate"``, the default of
``simulate`` and ``compare``: Algorithm 4's estimate, the segment
refinement and the aggregate pass, through the ``vi``,
``segment_resolve`` and ``first_crossing`` kernels on the card), Algorithm 2
(``method="parallel"``), the exact ``"sequential"`` oracle (one
capped-scan kernel launch on the card) and, for ``simulate`` only, the
``"naive_sampling"`` baseline (one capped-scan launch with a divisor).
Sweeps take ``chunks=`` and ``scenario_chunks=`` (bit for bit the
unchunked sweep), and :meth:`CounterfactualEngine.search` optimises a
design over a :class:`repro_torch.search.SearchSpace` with the parallel
sweep as its inner loop. A sweep also takes a compiled scenario family
(:func:`repro_torch.scenarios.compile_family`: typed interventions lowered
to a grid and an intervention overlay on common random numbers), and
:meth:`CounterfactualEngine.attribute` splits a family's revenue delta
into exact Shapley values over named intervention axes. Keys are
:mod:`repro_torch.prng` keys; the default is ``PRNGKey(0)``, as in
``repro``; a draw runs on the engine's device whatever device the key was
made on.
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
from repro_torch.core.executor import (DEFAULT_BLOCK_T, HostStream,
                                       check_s2a_options, execute_s2a_sweep,
                                       execute_sweep, plan_for_driver)
from repro_torch.core.parallel import parallel_simulate
from repro_torch.core.sequential import (naive_sampled_replay,
                                         sequential_replay)
from repro_torch.core.sort2aggregate import sort2aggregate as _sort2aggregate
from repro_torch.core.types import AuctionRule, SimResult
from repro_torch.device import DeviceLike, pick_device


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
    the CUDA card unless ``device`` says otherwise.

    ``service`` binds the engine to a
    :class:`repro_torch.serve.CounterfactualService`
    (``service.engine()``): its parallel sweeps, and so :meth:`search`, go
    through the service's admission batch and cache, with the same bits.
    ``values`` may then be the service's host-resident
    :class:`~repro_torch.core.executor.HostStream`."""

    def __init__(self, values, budgets,
                 base_rule: Optional[AuctionRule] = None,
                 device: DeviceLike = None, service=None):
        self.device = pick_device(device)
        self.values = values if isinstance(values, HostStream) else \
            torch.as_tensor(values).to(self.device, torch.float32)
        self.budgets = torch.as_tensor(budgets).to(self.device,
                                                   torch.float32)
        self.n_events, self.n_campaigns = self.values.shape
        self.base_rule = base_rule or AuctionRule.first_price(
            self.n_campaigns, device=self.device)
        self.service = service

    def _default_key(self) -> torch.Tensor:
        """``PRNGKey(0)`` on the engine's device: draws run where the
        values are."""
        return prng.PRNGKey(0, device=self.device)

    def simulate(self, rule: Optional[AuctionRule] = None,
                 budgets: Optional[torch.Tensor] = None,
                 method: str = "sort2aggregate",
                 key: Optional[torch.Tensor] = None,
                 **kwargs) -> SimResult:
        """One design's replay: ``"sort2aggregate"`` (``**kwargs`` going to
        :func:`~repro_torch.core.sort2aggregate.sort2aggregate`; ``key``
        defaults to ``PRNGKey(0)``), ``"parallel"`` (Algorithm 2,
        ``**kwargs`` going to
        :func:`~repro_torch.core.parallel.parallel_simulate`),
        ``"sequential"`` (the exact oracle) or ``"naive_sampling"``
        (:func:`~repro_torch.core.sequential.naive_sampled_replay`,
        ``sample_size=`` required; ``key`` defaults to ``PRNGKey(0)``)."""
        rule = rule or self.base_rule
        budgets = self.budgets if budgets is None else budgets
        if method == "sequential":
            return sequential_replay(self.values, budgets, rule, **kwargs)
        if method == "parallel":
            return parallel_simulate(self.values, budgets, rule, **kwargs)
        if method == "sort2aggregate":
            key = key if key is not None else self._default_key()
            return _sort2aggregate(self.values, budgets, rule, key,
                                   **kwargs).result
        if method == "naive_sampling":
            key = key if key is not None else self._default_key()
            return naive_sampled_replay(self.values, budgets, rule, key,
                                        **kwargs)
        raise ValueError(f"unknown method: {method}")

    def compare(self, alt_rule: AuctionRule,
                alt_budgets: Optional[torch.Tensor] = None,
                method: str = "sort2aggregate",
                key: Optional[torch.Tensor] = None,
                **kwargs) -> CounterfactualDelta:
        """The base design against ``alt_rule``/``alt_budgets``, each
        simulated with its half of a split of ``key``."""
        key = key if key is not None else self._default_key()
        k1, k2 = prng.split(key.to(self.device))
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

    def sweep(self, grid, method: str = "parallel",
              base_index: int = 0, record_events: bool = False,
              resolve: str = "auto", driver: str = "batched", *,
              warm_start="base", refine_iters: int = 8,
              crossing_block: int = 4096, key: Optional[torch.Tensor] = None,
              mesh=None, chunks=None, scenario_chunks=None,
              block_t=DEFAULT_BLOCK_T, tuned: bool = False) -> SweepResult:
        """Evaluate every scenario in ``grid`` in one batched program.

        ``grid`` is a :class:`ScenarioGrid` or a
        :class:`repro_torch.scenarios.CompiledFamily`, whose extended
        valuations (entrant columns) and intervention overlay go through
        the executor; a family with an overlay (live windows, CRN bid noise
        or participation) runs on ``method="parallel"`` only, and a
        per-event overlay on ``resolve="torch"`` only
        (:func:`~repro_torch.core.executor.check_overlay`).

        ``method="parallel"`` runs Algorithm 2 through the executor
        (``resolve="auto"``: the CUDA fused round on the card, the torch
        path on the CPU); ``method="sequential"`` runs the exact oracle for
        all lanes at once (one capped-scan launch on the card);
        ``method="sort2aggregate"`` refines every lane's segment history
        ``refine_iters`` times and aggregates it.

        ``chunks`` (an int or :class:`~repro_torch.core.executor.ChunkSpec`,
        ``"parallel"`` and ``"sort2aggregate"``) runs every round, or
        every refine pass, over event chunks; ``scenario_chunks``
        (``"parallel"`` only) over scenario chunks. The parallel sweep's
        results are bit for bit the unchunked sweep's; the chunked
        SORT2AGGREGATE sweep's cap times and gaps are too (at the same
        ``crossing_block``), its ``final_spend`` the carried running total.
        ``ChunkSpec(..., source="host")`` (``"parallel"`` only) streams the
        log from host memory chunk by chunk, with the same bits. A
        service-bound engine's parallel sweep goes through its service.

        ``warm_start`` (``"sort2aggregate"`` only) seeds the refinement:
        ``"base"`` (or ``True``, the default) with the base design's cap
        times from the single-design estimator; ``"per_scenario"`` with
        Algorithm 4 run for every lane on common random numbers; ``False``
        (or None) from the all-active state. ``crossing_block`` sizes the
        first-crossing scan. The result carries ``consistency_gaps`` and
        ``refine_iters`` per scenario.

        ``driver="sharded"`` runs the sweep on the mesh named by ``mesh``
        (a :class:`repro_torch.launch.mesh.SweepMeshSpec`): events over its
        event ranks, scenarios over its scenario axis. ``"parallel"`` is
        bit for bit the batched sweep; ``"sort2aggregate"`` runs the base
        warm start's Algorithm 4 (:func:`~repro_torch.core.sharded.
        estimate_pi_sharded`) and every refine and aggregate pass on the
        mesh too. ``driver="multihost"`` (``"parallel"`` only) runs the
        sharded program over a ``torch.distributed`` world
        (``mesh=SweepMeshSpec.for_processes()``): this engine's ``values``
        are this rank's rows of the global log, and every rank gets the
        one-process answers.

        ``block_t="auto"`` / ``tuned=True`` leave the plan's performance
        knobs to the tuner (:mod:`repro_torch.tune`): the executor resolves
        them from the tuning cache (one :meth:`tune` pass fills it) or the
        cost model, and the answers are the default plan's bit for bit."""
        from repro_torch.scenarios.family import CompiledFamily
        request = grid
        values, overlay = self.values, None
        if isinstance(grid, CompiledFamily):
            family = grid
            grid, values, overlay = family.grid, family.values, \
                family.overlay
            base_index = family.base_index
        if overlay is not None and method != "parallel":
            raise ValueError(
                "scenario families with an intervention overlay (live "
                "windows / CRN stochastic axes) run on the parallel "
                f"executor only; use method='parallel', not {method!r}.")
        plan = plan_for_driver(driver, resolve=resolve, mesh=mesh,
                               chunks=chunks,
                               scenario_chunks=scenario_chunks,
                               block_t=block_t, tuned=tuned)
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
        if self.service is not None and method == "parallel":
            # a service-bound engine answers through the service's batch and
            # cache; the service's plan wins over driver=/resolve=/chunks=
            # (every plan gives the same bits)
            if self.service.n_events != self.n_events:
                raise ValueError(
                    f"stale service-bound engine: the service log has "
                    f"{self.service.n_events} events but this engine wraps "
                    f"{self.n_events}; re-create it via service.engine() "
                    "after append().")
            return self.service.sweep(request, base_index=base_index)
        warm_start = {True: "base", False: None}.get(warm_start, warm_start)
        if warm_start not in (None, "base", "per_scenario"):
            raise ValueError(
                f"unknown warm_start mode: {warm_start!r} "
                "(use 'per_scenario', 'base', or False)")
        gaps = iters = None
        if method == "sort2aggregate":
            # fail fast before paying for a warm start
            check_s2a_options(plan, record_events)
            caps0 = None
            if warm_start == "per_scenario":
                caps0 = self._per_scenario_warm_caps(grid, key,
                                                     values=values)
            elif warm_start == "base":
                caps0 = self._base_warm_caps(grid, base_index, refine_iters,
                                             key, values=values,
                                             driver=driver, mesh=mesh)
            results, gaps, iters = execute_s2a_sweep(
                values, grid.budgets, grid.rules, plan,
                cap_times_init=caps0, refine_iters=refine_iters,
                record_events=record_events, crossing_block=crossing_block)
            return SweepResult(grid=grid, results=results,
                               n_events=self.n_events, base_index=base_index,
                               consistency_gaps=gaps, refine_iters=iters)
        if method == "parallel":
            s_hat, cap_times, _, _, _, _ = execute_sweep(
                values, grid.budgets, grid.rules, plan, overlay=overlay)
            results = SimResult(final_spend=s_hat, cap_times=cap_times)
        elif method == "sequential":
            if driver in ("sharded", "multihost"):
                raise ValueError(
                    "method='sequential' is the O(N)-serial validation "
                    "oracle and has no sharded/multihost driver; use "
                    "driver='batched', or method='parallel'/"
                    "'sort2aggregate' to scale out.")
            results = sweep_lib.sweep_sequential(
                values, grid.budgets, grid.rules,
                record_events=record_events)
        else:
            raise ValueError(f"unknown sweep method: {method}")
        return SweepResult(grid=grid, results=results,
                           n_events=self.n_events, base_index=base_index)

    def tune(self, grid=None, *, driver: str = "batched",
             resolve: str = "auto", mesh=None, chunks=None,
             scenario_chunks=None, cache=None, cache_path=None,
             max_events: int = 4096, trials: int = 7,
             quick_trials: int = 3, top_k: int = 4, measure: bool = True):
        """One measured tuning pass for this engine's log shape: the legal
        knob lattice of the (driver, resolve, chunks) plan, ranked by the
        cost model, the best candidates timed paired against the default
        plan, and the winner kept in the tuning cache, so every later
        same-shape ``sweep(..., tuned=True)`` (or ``block_t="auto"``)
        resolves to it without measuring. ``grid`` defaults to a small
        product grid; the decision keys on shapes, not designs. Returns
        the :class:`repro_torch.tune.TuneReport`. Every candidate gives
        the default plan's bits."""
        from repro_torch import tune as tune_lib
        if grid is None:
            grid = self.grid(bid_scales=(1.0, 1.25),
                             budget_scales=(1.0, 0.75))
        plan = plan_for_driver(driver, resolve=resolve, mesh=mesh,
                               chunks=chunks,
                               scenario_chunks=scenario_chunks,
                               block_t="auto", tuned=True)
        return tune_lib.autotune(
            self.values, grid.budgets, grid.rules, plan, cache=cache,
            cache_path=cache_path, max_events=max_events, trials=trials,
            quick_trials=quick_trials, top_k=top_k, measure=measure)

    def grid_from_points(self, points: Sequence[dict]) -> ScenarioGrid:
        """A :class:`ScenarioGrid` from search-space points: each point a
        ``{axis: float}`` dict over ``bid_scale`` / ``reserve`` /
        ``budget_scale`` applied to this engine's base design (a missing
        axis stays at the base, as in :meth:`ScenarioGrid.product`);
        ``boost[c]`` axes multiply campaign c's bid multiplier (a float32
        multiply) on top of ``bid_scale``."""
        dev = self.base_rule.multipliers.device
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
        scenarios, labels = [], []
        for p in points:
            bid = float(p.get("bid_scale", 1.0))
            res = float(p.get("reserve", float(self.base_rule.reserve)))
            bud = float(p.get("budget_scale", 1.0))
            mult = self.base_rule.multipliers * f32(bid)
            label = f"bid×{bid:g} res={res:g} bud×{bud:g}"
            for axis in sorted(p):
                if axis.startswith("boost[") and axis.endswith("]"):
                    c, scale = int(axis[6:-1]), float(p[axis])
                    mult = mult.clone()
                    mult[c] = mult[c] * f32(scale)
                    label += f" boost[{c}]×{scale:g}"
                elif axis not in ("bid_scale", "reserve", "budget_scale"):
                    raise ValueError(
                        f"unknown grid axis: {axis!r} (use bid_scale / "
                        "reserve / budget_scale / boost[c])")
            rule = AuctionRule(multipliers=mult, reserve=f32(res),
                               kind=self.base_rule.kind)
            scenarios.append((rule, self.budgets * f32(bud)))
            labels.append(label)
        return ScenarioGrid.from_scenarios(scenarios, labels)

    def search(self, space, *, objective="revenue", constraints=(),
               method: str = "hillclimb", budget: int = 256,
               resolve: str = "auto", driver: str = "batched", mesh=None,
               chunks=None, scenario_chunks=None, **options):
        """Optimise the design over ``space`` (a
        :class:`repro_torch.search.SearchSpace`) with the batched parallel
        sweep as the inner loop: ``objective`` an
        :data:`repro_torch.search.OBJECTIVES` name or a callable
        ``SweepResult -> (S,) scores`` (maximised), ``constraints``
        callables ``SweepResult -> (S,) margins``; ``method``
        ``"hillclimb"`` or ``"halving"``, ``options`` going to it.
        ``budget`` caps the scenario evaluations, each batch charged to an
        :class:`repro_torch.search.EvaluationLedger` before it runs.
        ``resolve``, ``driver``, ``mesh``, ``chunks`` and
        ``scenario_chunks`` configure the inner
        :meth:`sweep(method="parallel") <sweep>`, validated up front with
        the executor's errors. Returns a
        :class:`repro_torch.search.SearchResult`."""
        from repro_torch import search as search_lib
        # fail fast on the execution plan before any evaluation is spent
        plan_for_driver(driver, resolve=resolve, mesh=mesh, chunks=chunks,
                        scenario_chunks=scenario_chunks)
        objective_fn = search_lib.as_objective(objective)
        ledger = search_lib.EvaluationLedger(budget=int(budget))

        def evaluate(points, note):
            del note
            swept = self.sweep(
                self.grid_from_points(points), method="parallel",
                resolve=resolve, driver=driver, mesh=mesh, chunks=chunks,
                scenario_chunks=scenario_chunks)
            return search_lib.score_sweep(swept, objective_fn, constraints)

        if method == "halving":
            return search_lib.successive_halving(evaluate, space, ledger,
                                                 **options)
        if method == "hillclimb":
            return search_lib.coordinate_hillclimb(evaluate, space, ledger,
                                                   **options)
        names = ", ".join(repr(m) for m in search_lib.SEARCH_METHODS)
        raise ValueError(
            f"unknown search method: {method!r} (choose from {names})")

    def attribute(self, axes, *, objective="revenue",
                  key: Optional[torch.Tensor] = None, **sweep_kwargs):
        """Shapley-attribute a revenue delta across intervention axes:
        ``axes`` maps axis names to intervention specs, the 2^k subset
        lattice is compiled into one family on common random numbers
        (``key`` its CRN root) and swept in one batched program
        (``sweep_kwargs`` going to :meth:`sweep`), and the total delta is
        split into per-axis Shapley values that add up to it exactly
        (:func:`repro_torch.scenarios.attribute`). Returns a
        :class:`repro_torch.scenarios.ShapleyAttribution`."""
        from repro_torch.scenarios import attribution as attribution_lib
        return attribution_lib.attribute(self, axes, objective=objective,
                                         key=key, **sweep_kwargs)

    def _base_warm_caps(self, grid: ScenarioGrid, base_index: int,
                        refine_iters: int, key: Optional[torch.Tensor], *,
                        values: Optional[torch.Tensor] = None,
                        driver: str = "batched", mesh=None
                        ) -> torch.Tensor:
        """(C,) warm-start cap times from the base design (the paper's
        previous-day trick), on the sweep's placement: the single-design
        SORT2AGGREGATE of scenario ``base_index`` over ``values`` (a
        family's; the engine's by default), or on a mesh
        (``driver="sharded"``) Algorithm 4 with the residual summed over
        the shards, its cap times, and the base design's refinement on the
        mesh without its scenario axis."""
        values = self.values if values is None else values
        base_rule, base_budgets = grid.scenario(base_index)
        key = key if key is not None else self._default_key()
        if driver == "sharded":
            from repro_torch.core import sharded as sharded_lib
            n_events = values.shape[0]
            pi = sharded_lib.estimate_pi_sharded(
                mesh.mesh, values, base_budgets, base_rule, key,
                event_axes=mesh.event_axes)
            caps_pi = vi_lib.pi_to_cap_times(pi, n_events)
            base_mesh = dataclasses.replace(mesh, scenario_axis=None)
            base_res, _, _ = sharded_lib.sweep_sort2aggregate_sharded(
                values, base_budgets[None, :],
                sweep_lib.stack_rules([base_rule]), base_mesh,
                cap_times_init=caps_pi, refine_iters=refine_iters)
            return torch.clamp(base_res.cap_times[0], max=n_events + 1)
        base = _sort2aggregate(values, base_budgets, base_rule, key,
                               refine_iters=refine_iters)
        return base.result.cap_times

    def _per_scenario_warm_caps(self, grid: ScenarioGrid,
                                key: Optional[torch.Tensor],
                                sample_rate: float = 0.1,
                                vi_iters: int = 80,
                                vi_batch_size: int = 64,
                                vi_eta_decay: float = 0.05, *,
                                values: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
        """(S, C) warm-start cap times: Algorithm 4 for every scenario on
        the same sample and draws (common random numbers), each under its
        own design, with a larger VI budget than the single-design default
        (10% sample, 80 epochs, decayed steps), as in ``repro``."""
        values = self.values if values is None else values
        n_events = values.shape[0]
        sample_size = max(int(round(n_events * sample_rate)),
                          vi_batch_size)
        est = vi_lib.estimate_pi_sweep(
            values, grid.budgets, grid.rules,
            key if key is not None else self._default_key(),
            sample_size=sample_size, num_iters=vi_iters,
            batch_size=vi_batch_size, eta_decay=vi_eta_decay)
        return vi_lib.pi_to_cap_times(est.pi, n_events)
