"""Objectives and constraints over swept scenario batches (port of
``repro.search.objectives``).

An *objective* maps a :class:`~repro_torch.core.counterfactual.SweepResult`
to a per-scenario score array (S,), to maximize. A *constraint* maps the
same sweep to per-scenario feasibility *margins* (S,): ``margin >= 0``
means feasible, and the magnitude ranks candidates when nothing is
feasible (least-violating first). Both read the exact quantities the delta
table reports — revenue is the summed clearing prices, the cap-out rate is
``num_capped / C`` — so a search optimizes precisely what
``SweepResult.delta_table()`` would show. The sweep's tensors are read on
the host (the scores are numpy).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple, Union

import numpy as np
import torch


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def revenue_objective(sweep) -> np.ndarray:
    """Platform revenue per scenario: summed clearing prices over the day
    (the delta table's ``revenue`` column)."""
    return _host(sweep.results.revenue, np.float64)


def spend_objective(sweep) -> np.ndarray:
    """Total per-scenario spend (equals revenue when per-event prices are
    not recorded; kept separate so recorded sweeps can tell them apart)."""
    return _host(sweep.results.final_spend, np.float64).sum(-1)


OBJECTIVES = {"revenue": revenue_objective, "spend": spend_objective}

Objective = Union[str, Callable[[object], np.ndarray]]
Constraint = Callable[[object], np.ndarray]


def as_objective(objective: Objective) -> Callable[[object], np.ndarray]:
    if callable(objective):
        return objective
    if objective not in OBJECTIVES:
        names = ", ".join(repr(k) for k in OBJECTIVES)
        raise ValueError(
            f"unknown objective: {objective!r} (choose from {names}, or "
            "pass a callable SweepResult -> (S,) scores)")
    return OBJECTIVES[objective]


@dataclasses.dataclass(frozen=True)
class CapRateCeiling:
    """Feasible iff at most ``ceiling`` of the campaigns cap out in-day.

    The rate is the delta table's ``num_capped`` over C: the fraction of
    campaigns whose budget burned out within the day (``cap_time <= N``).
    Margin = ``ceiling - rate`` (non-negative when feasible).
    """

    ceiling: float

    def __post_init__(self):
        if not 0.0 <= self.ceiling <= 1.0:
            raise ValueError(
                f"cap-out ceiling must be a rate in [0, 1], got "
                f"{self.ceiling}")

    def __call__(self, sweep) -> np.ndarray:
        caps = _host(sweep.results.cap_times, np.int64)
        rate = (caps <= sweep.n_events).sum(-1) / caps.shape[-1]
        return self.ceiling - rate


def score_sweep(sweep, objective: Callable[[object], np.ndarray],
                constraints: Sequence[Constraint]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(values, margins) per scenario; margin = min over constraints
    (+inf-free: unconstrained searches get margin 0 everywhere, feasible)."""
    values = np.asarray(objective(sweep), np.float64)
    if not constraints:
        return values, np.zeros_like(values)
    margins = np.min([np.asarray(c(sweep), np.float64)
                      for c in constraints], axis=0)
    return values, margins
