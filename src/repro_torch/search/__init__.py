"""Scenario-space search over the sweep engine (port of ``repro.search``).

A :class:`SearchSpace` names box bounds over the grid axes (bid scale ×
reserve × budget scale, and per-campaign ``boost[c]``), an optimizer
proposes scenario batches, the batched Algorithm-2 sweep evaluates each
batch as one program, and an :class:`EvaluationLedger` charges every
scenario evaluation against an explicit budget before the sweep runs
(:class:`BudgetExhausted` otherwise). Two deterministic, derivative-free
optimizers: :func:`successive_halving` (rungs of shrinking boxes) and
:func:`coordinate_hillclimb` (a pattern search, one batch a step).
Constraints such as :class:`CapRateCeiling` enter as feasibility margins.

The entry point is
:meth:`repro_torch.core.counterfactual.CounterfactualEngine.search`. The
package is pure Python and numpy; its trajectories are ``repro``'s when
the sweeps give ``repro``'s numbers.
"""
from repro_torch.search.ledger import BudgetExhausted, EvaluationLedger
from repro_torch.search.objectives import (OBJECTIVES, CapRateCeiling,
                                           as_objective, revenue_objective,
                                           score_sweep, spend_objective)
from repro_torch.search.optimize import (SEARCH_METHODS, SearchResult,
                                         coordinate_hillclimb,
                                         successive_halving)
from repro_torch.search.space import SEARCH_AXES, SearchSpace

__all__ = [
    "BudgetExhausted", "EvaluationLedger",
    "OBJECTIVES", "CapRateCeiling", "as_objective", "revenue_objective",
    "spend_objective", "score_sweep",
    "SEARCH_METHODS", "SearchResult", "coordinate_hillclimb",
    "successive_halving",
    "SEARCH_AXES", "SearchSpace",
]
