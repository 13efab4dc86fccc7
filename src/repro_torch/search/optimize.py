"""Gradient-free optimizers driving the batched sweep as their inner loop
(port of ``repro.search.optimize``; pure Python and numpy).

Both optimizers consume an ``evaluate(points, note) -> (values, margins)``
callback (one batched sweep per call — every proposal batch is a single
S-lane device program) and an :class:`~repro_torch.search.ledger.EvaluationLedger`
they charge BEFORE each call, so the evaluation trail is exact: a batch
either fits the budget and is fully accounted, or the optimizer stops with
what it has (``converged=False``) — never a partial or unrecorded sweep.

Candidate selection is feasibility-first (see
:mod:`repro_torch.search.objectives`): a feasible candidate with the highest
objective wins; with no feasible candidate anywhere, the least-violating
margin wins, so constrained searches steer back toward the feasible region.

Deterministic by construction — fixed grids and coordinate steps, no RNG —
so a search trajectory is reproducible run-to-run (and the golden
convergence tests in tests/test_torch_search.py can assert exact ledger trails).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.search.ledger import EvaluationLedger
from repro_torch.search.space import SearchSpace

SEARCH_METHODS = ("halving", "hillclimb")

Evaluate = Callable[[List[Dict[str, float]], str],
                    Tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass
class SearchResult:
    """Outcome of a scenario-space search.

    ``evaluations == ledger.spent == sum(batch sizes in history)`` — the
    exactness invariant. ``converged`` is True when the optimizer hit its
    resolution target (``xatol``) rather than running out of budget or
    iterations.
    """

    best_point: Dict[str, float]
    best_value: float
    best_feasible: bool
    evaluations: int
    ledger: EvaluationLedger
    history: List[dict]
    converged: bool

    def format_trajectory(self) -> str:
        lines = [f"{'batch':<22} {'evals':>6} {'best value':>12} "
                 f"{'feasible':>9}"]
        lines.append("-" * len(lines[0]))
        for h in self.history:
            lines.append(f"{h['note']:<22} {h['evaluations']:>6d} "
                         f"{h['best_value']:>12.2f} "
                         f"{str(h['best_feasible']):>9}")
        lines.append(f"total: {self.evaluations} evaluations "
                     f"(budget {self.ledger.budget}) -> "
                     f"{self.best_point} = {self.best_value:.2f}"
                     f"{'' if self.best_feasible else ' [INFEASIBLE]'}")
        return "\n".join(lines)


def _key(value: float, margin: float) -> Tuple[int, float]:
    """Selection key: feasible-by-objective over infeasible-by-margin."""
    return (1, value) if margin >= 0 else (0, margin)


def _select(values: np.ndarray, margins: np.ndarray) -> int:
    return max(range(len(values)),
               key=lambda i: _key(float(values[i]), float(margins[i])))


class _Incumbent:
    def __init__(self):
        self.point = None
        self.value = -np.inf
        self.margin = -np.inf

    def offer(self, point, value, margin):
        if self.point is None or \
                _key(value, margin) > _key(self.value, self.margin):
            self.point, self.value, self.margin = dict(point), value, margin


def successive_halving(evaluate: Evaluate, space: SearchSpace,
                       ledger: EvaluationLedger, *,
                       num_candidates: int = 16, eta: int = 2,
                       shrink: float = 0.25, min_rung: int = 3,
                       xatol: float = 1e-2, max_rounds: int = 16
                       ) -> SearchResult:
    """Successive halving over a shrinking box.

    Each rung evaluates a balanced grid over the current box as ONE
    scenario batch, then re-centers a ``shrink``-factor box on the rung
    winner and decays the rung size by ``eta`` (never below ``min_rung``).
    With ``shrink < 1/eta`` in 1-D the grid spacing contracts every rung,
    so resolution ``δ`` costs O(num_candidates · log(width/δ)) total
    evaluations against the exhaustive grid's O(width/δ). Stops when every
    box width is within ``xatol`` of the full axis width (``converged``),
    or when the next rung no longer fits the ledger.
    """
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")
    box = space.bounds()
    full = space.widths()
    k = num_candidates
    best = _Incumbent()
    history: List[dict] = []
    converged = False
    for rung in range(max_rounds):
        pts = space.grid(k, box=box)
        note = f"halving rung {rung}"
        if not ledger.affordable(len(pts)):
            break
        ledger.charge(len(pts), note)
        values, margins = evaluate(pts, note)
        i = _select(values, margins)
        best.offer(pts[i], float(values[i]), float(margins[i]))
        history.append({
            "note": note, "evaluations": len(pts),
            "points": pts, "values": values, "margins": margins,
            "best_point": dict(pts[i]), "best_value": float(values[i]),
            "best_feasible": bool(margins[i] >= 0),
        })
        box = space.shrink_around(pts[i], shrink, box=box)
        if all(w <= xatol * full[a] for a, w in space.widths(box).items()):
            converged = True
            break
        k = max(min_rung, k // eta)
    return SearchResult(
        best_point=best.point or space.center(), best_value=best.value,
        best_feasible=best.margin >= 0, evaluations=ledger.spent,
        ledger=ledger, history=history, converged=converged)


def coordinate_hillclimb(evaluate: Evaluate, space: SearchSpace,
                         ledger: EvaluationLedger, *,
                         init: Optional[Dict[str, float]] = None,
                         step_frac: float = 0.25, shrink: float = 0.5,
                         xatol: float = 1e-2, max_iters: int = 64
                         ) -> SearchResult:
    """Coordinate pattern search: evaluate the ±step neighborhood of the
    incumbent as ONE scenario batch per iteration; move to the best
    improving neighbor, else halve every step. Stops when all steps are
    within ``xatol`` of the axis widths (``converged``) or the next
    neighborhood no longer fits the ledger.

    The hypothesis → measure → record loop follows the perf hillclimb
    driver (``repro``'s ``launch.hillclimb``), with the measurement a batched
    counterfactual sweep instead of a compile.
    """
    x = space.clip(dict(init) if init else space.center())
    widths = space.widths()
    steps = {a: w * step_frac for a, w in widths.items()}
    ledger.charge(1, "hillclimb init")
    values, margins = evaluate([x], "hillclimb init")
    best = _Incumbent()
    best.offer(x, float(values[0]), float(margins[0]))
    history = [{
        "note": "hillclimb init", "evaluations": 1, "points": [dict(x)],
        "values": values, "margins": margins, "best_point": dict(x),
        "best_value": float(values[0]),
        "best_feasible": bool(margins[0] >= 0),
    }]
    converged = False
    for it in range(max_iters):
        if all(steps[a] <= xatol * widths[a] for a in steps):
            converged = True
            break
        nbrs = []
        for a in space.axes:
            for d in (1.0, -1.0):
                p = space.clip({**x, a: x[a] + d * steps[a]})
                if p != x and p not in nbrs:
                    nbrs.append(p)
        note = f"hillclimb iter {it}"
        if not nbrs or not ledger.affordable(len(nbrs)):
            break
        ledger.charge(len(nbrs), note)
        values, margins = evaluate(nbrs, note)
        i = _select(values, margins)
        moved = _key(float(values[i]), float(margins[i])) > \
            _key(best.value, best.margin)
        if moved:
            x = nbrs[i]
            best.offer(x, float(values[i]), float(margins[i]))
        else:
            steps = {a: s * shrink for a, s in steps.items()}
        history.append({
            "note": note, "evaluations": len(nbrs), "points": nbrs,
            "values": values, "margins": margins, "best_point": dict(x),
            "best_value": best.value, "best_feasible": best.margin >= 0,
            "moved": moved,
        })
    return SearchResult(
        best_point=best.point, best_value=best.value,
        best_feasible=best.margin >= 0, evaluations=ledger.spent,
        ledger=ledger, history=history, converged=converged)
