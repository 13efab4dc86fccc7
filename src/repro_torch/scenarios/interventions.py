"""Typed intervention specs — the vocabulary of targeted counterfactuals
(port of ``repro.scenarios.interventions``).

A scenario in a :func:`repro_torch.scenarios.compile_family` family is a
*sequence* of interventions applied, in order, to a mutable per-scenario
:class:`ScenarioLane` (budgets / multipliers / reserve rows plus live windows
and stochastic-axis parameters). Compilation lowers the whole family to the
batched design arrays the sweep executor already consumes — a
:class:`~repro_torch.core.counterfactual.ScenarioGrid` plus an optional
:class:`~repro_torch.core.types.ScenarioOverlay` — so every intervention
composes bit-for-bit with every placement / resolve / chunking axis.

Two kinds of spec:

* **design interventions** (:class:`BoostCampaign`, :class:`ScaleBids`,
  :class:`ScaleBudget`, :class:`ScaleBudgets`, :class:`SetReserve`,
  :class:`MultiplierJitter`) only rewrite the design row — families built
  purely from these compile with ``overlay=None`` and keep every estimator
  (including SORT2AGGREGATE warm starts) available;
* **eligibility / stochastic interventions** (:class:`PauseCampaign`,
  :class:`BudgetPacing`, :class:`AddEntrant`, :class:`BidNoise`,
  :class:`ParticipationJitter`) need the overlay's live windows or CRN
  streams (:mod:`repro_torch.core.crn`) and run on the parallel executor.

Interventions apply **in sequence**: ``[ScaleBids(1.2), BoostCampaign(3,
2.0)]`` boosts campaign 3 by ``1.2 × 2.0`` total. Window interventions
*intersect* (a pacing window inside a pause stays paused).

The lane arithmetic is ``repro``'s numpy code, so a family compiles to the
same arrays in both packages. The CRN draws (entrant columns, multiplier
jitter) run on the family's device (``FamilyContext.device``), with
``repro``'s bits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import crn


@dataclasses.dataclass
class ScenarioLane:
    """Mutable per-scenario design row the interventions rewrite.

    Arrays span the *extended* campaign axis (base campaigns first, then one
    column per distinct :class:`AddEntrant` slot). Windows are half-open
    ``[start, stop)`` over global event indices; entrant columns start with
    an empty window (paused everywhere) until an :class:`AddEntrant` opens
    them.
    """

    budgets: np.ndarray       # (C_total,) float
    multipliers: np.ndarray   # (C_total,) float
    reserve: float
    live_start: np.ndarray    # (C_total,) int
    live_stop: np.ndarray     # (C_total,) int
    bid_sigma: np.ndarray     # (C_total,) float
    part_prob: np.ndarray     # (C_total,) float


@dataclasses.dataclass(frozen=True)
class FamilyContext:
    """Compile-time facts shared by every lane of a family."""

    n_events: int
    n_base: int                        # base campaign count
    n_total: int                       # base + entrant slots
    entrant_slots: dict                # slot label -> extended column index
    key: Optional[torch.Tensor]        # family PRNG key (CRN root)
    device: torch.device = torch.device("cpu")   # where the draws run

    def require_key(self, who: str) -> torch.Tensor:
        if self.key is None:
            raise ValueError(
                f"{who} draws from the family CRN streams; pass key= to "
                "compile_family")
        return self.key

    def check_campaign(self, c: int, who: str) -> int:
        c = int(c)
        if not 0 <= c < self.n_base:
            raise ValueError(
                f"{who}: campaign {c} out of range for {self.n_base} base "
                "campaigns")
        return c


class Intervention:
    """Base class: a typed, order-sensitive edit of one scenario lane."""

    def apply(self, lane: ScenarioLane, ctx: FamilyContext) -> None:
        raise NotImplementedError

    def label(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PauseCampaign(Intervention):
    """Campaign ``campaign`` never participates: empty live window ⇒ final
    spend 0 and never caps out."""

    campaign: int

    def apply(self, lane, ctx):
        c = ctx.check_campaign(self.campaign, "PauseCampaign")
        lane.live_start[c] = 0
        lane.live_stop[c] = 0

    def label(self):
        return f"pause[{self.campaign}]"


@dataclasses.dataclass(frozen=True)
class BoostCampaign(Intervention):
    """Scale one campaign's bid multiplier (design-only)."""

    campaign: int
    scale: float = 2.0

    def apply(self, lane, ctx):
        c = ctx.check_campaign(self.campaign, "BoostCampaign")
        lane.multipliers[c] *= self.scale

    def label(self):
        return f"boost[{self.campaign}]×{self.scale:g}"


@dataclasses.dataclass(frozen=True)
class ScaleBids(Intervention):
    """Scale every campaign's bid multiplier (the grid's ``bid_scale``)."""

    scale: float

    def apply(self, lane, ctx):
        lane.multipliers *= self.scale

    def label(self):
        return f"bid×{self.scale:g}"


@dataclasses.dataclass(frozen=True)
class ScaleBudget(Intervention):
    """Scale one campaign's budget (design-only)."""

    campaign: int
    scale: float

    def apply(self, lane, ctx):
        c = ctx.check_campaign(self.campaign, "ScaleBudget")
        lane.budgets[c] *= self.scale

    def label(self):
        return f"budget[{self.campaign}]×{self.scale:g}"


@dataclasses.dataclass(frozen=True)
class ScaleBudgets(Intervention):
    """Scale every campaign's budget (the grid's ``budget_scale``)."""

    scale: float

    def apply(self, lane, ctx):
        lane.budgets *= self.scale

    def label(self):
        return f"bud×{self.scale:g}"


@dataclasses.dataclass(frozen=True)
class SetReserve(Intervention):
    """Set the auction reserve price (design-only)."""

    reserve: float

    def apply(self, lane, ctx):
        lane.reserve = float(self.reserve)

    def label(self):
        return f"res={self.reserve:g}"


@dataclasses.dataclass(frozen=True)
class BudgetPacing(Intervention):
    """Restrict a campaign to the pacing window ``[start, stop)`` (global
    event indices; ``stop=None`` = end of log). ``start > 0`` is a delayed
    start. Windows *intersect* with whatever window the lane already has,
    so stacking pacing schedules narrows eligibility monotonically."""

    campaign: int
    start: int = 0
    stop: Optional[int] = None

    def apply(self, lane, ctx):
        c = ctx.check_campaign(self.campaign, "BudgetPacing")
        stop = ctx.n_events if self.stop is None else int(self.stop)
        if not 0 <= self.start <= stop <= ctx.n_events:
            raise ValueError(
                f"BudgetPacing: window [{self.start}, {stop}) invalid for "
                f"{ctx.n_events} events")
        lane.live_start[c] = max(int(lane.live_start[c]), int(self.start))
        lane.live_stop[c] = min(int(lane.live_stop[c]), stop)

    def label(self):
        stop = "N" if self.stop is None else f"{self.stop}"
        return f"pace[{self.campaign}]@[{self.start},{stop})"


@dataclasses.dataclass(frozen=True)
class AddEntrant(Intervention):
    """Inject a new campaign into this scenario.

    Every distinct ``slot`` label across the family gets one extended
    valuation column, shared by all scenarios (CRN: the same entrant sees
    the same per-event values everywhere it appears); the column is drawn
    from the ``"entrant_value"`` stream of the family key scaled by
    ``value_scale``, unless explicit per-event ``values`` are given. The
    entrant is live in ``[start, stop)`` only in scenarios carrying this
    intervention — everywhere else its window is empty, so it is exactly a
    paused campaign.
    """

    budget: float
    multiplier: float = 1.0
    start: int = 0
    stop: Optional[int] = None
    values: Optional[np.ndarray] = None   # (N,) explicit valuations
    value_scale: float = 1.0
    slot: str = "entrant"

    def apply(self, lane, ctx):
        col = ctx.entrant_slots[self.slot]
        stop = ctx.n_events if self.stop is None else int(self.stop)
        if not 0 <= self.start <= stop <= ctx.n_events:
            raise ValueError(
                f"AddEntrant: window [{self.start}, {stop}) invalid for "
                f"{ctx.n_events} events")
        lane.budgets[col] = float(self.budget)
        lane.multipliers[col] = float(self.multiplier)
        lane.live_start[col] = int(self.start)
        lane.live_stop[col] = stop

    def column_values(self, ctx: FamilyContext) -> torch.Tensor:
        """The (N,) float32 valuation column for this entrant's slot, on
        ``ctx.device``."""
        if self.values is not None:
            vals = np.asarray(self.values, np.float32)
            if vals.shape != (ctx.n_events,):
                raise ValueError(
                    f"AddEntrant(slot={self.slot!r}): values shape "
                    f"{vals.shape} != ({ctx.n_events},)")
            return torch.from_numpy(vals.copy()).to(ctx.device)
        key = ctx.require_key(f"AddEntrant(slot={self.slot!r})")
        k = prng.fold_in(crn.stream_key(key.to(ctx.device), "entrant_value"),
                         ctx.entrant_slots[self.slot])
        draws = prng.uniform(k, (ctx.n_events,))
        return draws * torch.tensor(self.value_scale, dtype=torch.float32,
                                    device=ctx.device)

    def label(self):
        return f"entrant[{self.slot}]"


@dataclasses.dataclass(frozen=True)
class BidNoise(Intervention):
    """Multiplicative log-normal bid noise: effective values become
    ``values * exp(sigma * z)`` with ``z`` the ``"bid_noise"`` CRN stream —
    one draw per (event, campaign), shared by every scenario, so deltas
    between noisy scenarios isolate ``sigma`` itself. ``campaign=None``
    applies to all campaigns."""

    sigma: float
    campaign: Optional[int] = None

    def apply(self, lane, ctx):
        ctx.require_key("BidNoise")
        if self.campaign is None:
            lane.bid_sigma[:] = self.sigma
        else:
            c = ctx.check_campaign(self.campaign, "BidNoise")
            lane.bid_sigma[c] = self.sigma

    def label(self):
        who = "*" if self.campaign is None else f"{self.campaign}"
        return f"noise[{who}]σ={self.sigma:g}"


@dataclasses.dataclass(frozen=True)
class ParticipationJitter(Intervention):
    """Campaigns skip events: eligible at event ``n`` iff ``u[n, c] <
    prob``, with ``u`` the ``"participation"`` CRN stream (shared across
    scenarios). ``campaign=None`` applies to all campaigns."""

    prob: float
    campaign: Optional[int] = None

    def apply(self, lane, ctx):
        ctx.require_key("ParticipationJitter")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(
                f"ParticipationJitter: prob {self.prob} outside [0, 1]")
        if self.campaign is None:
            lane.part_prob[:] = self.prob
        else:
            c = ctx.check_campaign(self.campaign, "ParticipationJitter")
            lane.part_prob[c] = self.prob

    def label(self):
        who = "*" if self.campaign is None else f"{self.campaign}"
        return f"part[{who}]p={self.prob:g}"


@dataclasses.dataclass(frozen=True)
class MultiplierJitter(Intervention):
    """Design-only stochastic family member: multiply campaign multipliers
    by ``exp(sigma * z_c)`` with ``z`` the per-campaign
    ``"multiplier_jitter"`` CRN stream at index ``draw``. Different draws
    give i.i.d. design perturbations that still share every other random
    quantity — the CRN-keyed pi-perturbation model the per-scenario warm
    start is measured under. Compiles to pure design arrays (no overlay),
    so SORT2AGGREGATE and its warm starts stay available."""

    sigma: float
    draw: int = 0
    campaign: Optional[int] = None

    def apply(self, lane, ctx):
        key = ctx.require_key("MultiplierJitter")
        k = prng.fold_in(crn.stream_key(key.to(ctx.device),
                                        "multiplier_jitter"), int(self.draw))
        # drawn on the family's device, then repro's host numpy update
        z = crn.campaign_normals(k, ctx.n_total).cpu().numpy()
        if self.campaign is None:
            lane.multipliers *= np.exp(self.sigma * z)
        else:
            c = ctx.check_campaign(self.campaign, "MultiplierJitter")
            lane.multipliers[c] *= float(np.exp(self.sigma * z[c]))

    def label(self):
        who = "*" if self.campaign is None else f"{self.campaign}"
        return f"jitter[{who}]σ={self.sigma:g}#{self.draw}"


def as_interventions(spec) -> Sequence[Intervention]:
    """Normalize one scenario spec to a tuple of interventions.

    Accepts a single :class:`Intervention`, a sequence of them, or the
    grid-axis dict sugar ``{"bid_scale": 1.2, "reserve": 0.1,
    "budget_scale": 0.5, "boost[3]": 2.0}`` matching
    :meth:`~repro_torch.core.counterfactual.ScenarioGrid.product` /
    ``grid_from_points`` axis names.
    """
    if isinstance(spec, Intervention):
        return (spec,)
    if isinstance(spec, dict):
        out = []
        for axis, val in spec.items():
            if axis == "bid_scale":
                out.append(ScaleBids(float(val)))
            elif axis == "reserve":
                out.append(SetReserve(float(val)))
            elif axis == "budget_scale":
                out.append(ScaleBudgets(float(val)))
            elif axis.startswith("boost[") and axis.endswith("]"):
                out.append(BoostCampaign(int(axis[6:-1]), float(val)))
            else:
                raise ValueError(
                    f"unknown scenario axis: {axis!r} (use bid_scale / "
                    "reserve / budget_scale / boost[c], or pass "
                    "Intervention objects)")
        return tuple(out)
    specs = tuple(spec)
    for s in specs:
        if not isinstance(s, Intervention):
            raise TypeError(f"not an Intervention: {s!r}")
    return specs
