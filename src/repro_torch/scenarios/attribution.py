"""Counterfactual-Shapley attribution over scenario axes (port of
``repro.scenarios.attribution``).

``engine.attribute()`` answers "which intervention moved revenue, and by how
much": given k named intervention axes, it evaluates the full 2^k lattice of
axis subsets in ONE batched sweep (every subset is a scenario of a compiled
family, all sharing the CRN world) and decomposes the total delta

    v(all axes) - v(∅)

into per-axis Shapley values (Sharma et al.'s counterfactual-Shapley
estimand, PAPERS.md) computed by exact subset enumeration:

    φ_i = Σ_{S ⊆ A\\{i}}  |S|! (k-|S|-1)! / k!  · [v(S ∪ {i}) − v(S)]

The weights are exact rationals (``fractions.Fraction``) and the subset
values enter as exact binary rationals, so the **efficiency axiom**
``Σ_i φ_i = v(A) − v(∅)`` holds exactly up to one final float
rounding — and *bit-exactly* on the dyadic golden grids of ``repro``'s
tests/test_scenarios.py.
Exact enumeration costs 2^k scenarios; attribution is meant for a handful
of named axes (k ≲ 10), not for per-campaign fleets.
"""
from __future__ import annotations

import dataclasses
import itertools
from fractions import Fraction
from math import factorial
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.scenarios.family import compile_family
from repro_torch.scenarios.interventions import as_interventions


def shapley_values(
    axes: Sequence[str],
    subset_values: Dict[frozenset, float],
) -> Dict[str, float]:
    """Exact Shapley values from a complete subset-value table.

    ``subset_values`` must hold v(S) for every ``S ⊆ frozenset(axes)``
    (2^k entries). Weights are exact fractions; each φ is rounded to float
    once at the end.
    """
    axes = tuple(axes)
    k = len(axes)
    full = frozenset(axes)
    missing = [s for r in range(k + 1)
               for s in map(frozenset, itertools.combinations(axes, r))
               if s not in subset_values]
    if missing:
        raise ValueError(
            f"subset_values is missing {len(missing)} of {2 ** k} subsets "
            f"of {sorted(full)} (first: {sorted(missing[0])})")
    kfact = factorial(k)
    phi = {}
    for i in axes:
        rest = [a for a in axes if a != i]
        total = Fraction(0)
        for r in range(len(rest) + 1):
            w = Fraction(factorial(r) * factorial(k - r - 1), kfact)
            for combo in itertools.combinations(rest, r):
                s = frozenset(combo)
                total += w * (Fraction(subset_values[s | {i}])
                              - Fraction(subset_values[s]))
        phi[i] = float(total)
    return phi


@dataclasses.dataclass(frozen=True)
class ShapleyAttribution:
    """Per-axis decomposition of a scenario family's total delta."""

    axes: Tuple[str, ...]
    phi: Dict[str, float]                 # axis -> Shapley value
    base_value: float                     # v(∅) — the base design
    total_value: float                    # v(all axes)
    subset_values: Dict[frozenset, float]
    objective: str = "revenue"

    @property
    def total_delta(self) -> float:
        return self.total_value - self.base_value

    @property
    def efficiency_gap(self) -> float:
        """|Σφ − total_delta| — 0 up to one float rounding (exactly 0 on
        dyadic grids), asserted by the golden tests."""
        return abs(sum(self.phi.values()) - self.total_delta)

    def format_table(self) -> str:
        hdr = f"{'axis':<24} {'shapley Δ' + self.objective:>16} {'share':>8}"
        lines = [hdr, "-" * len(hdr)]
        denom = self.total_delta if self.total_delta != 0 else 1.0
        for a in self.axes:
            lines.append(f"{a:<24} {self.phi[a]:>+16.4f} "
                         f"{self.phi[a] / denom:>7.1%}")
        lines.append("-" * len(hdr))
        lines.append(f"{'total':<24} {self.total_delta:>+16.4f} {1:>7.1%}")
        return "\n".join(lines)


def attribute(
    engine,
    axes: Dict[str, object],
    *,
    objective: Union[str, Callable] = "revenue",
    key: Optional[torch.Tensor] = None,
    **sweep_kwargs,
) -> ShapleyAttribution:
    """Shapley-attribute an engine's revenue delta across intervention axes.

    ``axes`` maps axis names to scenario specs (anything
    :func:`~repro_torch.scenarios.interventions.as_interventions` accepts
    — an Intervention, a sequence, or grid-axis dict sugar). All 2^k subset
    combinations are compiled into one family (subsets compose by
    concatenating their axes' interventions in ``axes`` order) and swept in
    one batched program under the shared CRN key, so every subset sees the
    same random world.

    ``objective`` is ``"revenue"`` (default), ``"spend"`` (total spend), or
    a callable ``SimResult -> (S,) scores``. Extra ``sweep_kwargs``
    (resolve / driver / chunks / scenario_chunks) go to
    :meth:`~repro_torch.core.counterfactual.CounterfactualEngine.sweep`.
    """
    names = tuple(axes)
    if not names:
        raise ValueError("attribute() needs at least one axis")
    specs = {n: tuple(as_interventions(axes[n])) for n in names}
    subsets = [frozenset(c) for r in range(1, len(names) + 1)
               for c in itertools.combinations(names, r)]
    scenarios = [sum((specs[n] for n in names if n in s), ())
                 for s in subsets]
    family = compile_family(
        engine.values, engine.budgets, engine.base_rule, scenarios, key=key,
        labels=[" + ".join(n for n in names if n in s) for s in subsets])
    swept = engine.sweep(family, method="parallel", **sweep_kwargs)

    if callable(objective):
        scores = objective(swept.results)
        obj_name = getattr(objective, "__name__", "objective")
    elif objective == "revenue":
        scores, obj_name = swept.results.revenue, "revenue"
    elif objective == "spend":
        scores = swept.results.final_spend.sum(-1)
        obj_name = "spend"
    else:
        raise ValueError(
            f"unknown objective: {objective!r} (use 'revenue', 'spend', or "
            "a callable)")
    scores = [float(x) for x in scores]

    subset_values = {frozenset(): scores[0]}   # scenario 0 = base = v(∅)
    for i, s in enumerate(subsets):
        subset_values[s] = scores[i + 1]
    phi = shapley_values(names, subset_values)
    return ShapleyAttribution(
        axes=names, phi=phi, base_value=subset_values[frozenset()],
        total_value=subset_values[frozenset(names)],
        subset_values=subset_values, objective=obj_name)
