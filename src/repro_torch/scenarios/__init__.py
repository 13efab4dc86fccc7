"""Scenario families: targeted interventions under a CRN contract (port of
``repro.scenarios``).

The layer above the cartesian
:class:`~repro_torch.core.counterfactual.ScenarioGrid`: typed
interventions (:mod:`~repro_torch.scenarios.interventions`) compile
(:func:`compile_family`) to the design arrays + eligibility/stochastic
overlay the sweep executor consumes, with every random quantity drawn from
per-(event, campaign) common-random-number streams
(:mod:`repro_torch.core.crn`) so scenario deltas isolate the intervention by
construction. Shapley
attribution (:func:`attribute`) decomposes the resulting deltas across named
axes.
"""
from repro_torch.scenarios.interventions import (
    AddEntrant, BidNoise, BoostCampaign, BudgetPacing, FamilyContext,
    Intervention, MultiplierJitter, ParticipationJitter, PauseCampaign,
    ScaleBids, ScaleBudget, ScaleBudgets, ScenarioLane, SetReserve,
    as_interventions)
from repro_torch.scenarios.family import (
    CompiledFamily, compile_family, design_fingerprint, family_fingerprint,
    family_fingerprints, grid_fingerprints)
from repro_torch.scenarios.attribution import (ShapleyAttribution,
                                               attribute, shapley_values)

__all__ = [
    "Intervention", "PauseCampaign", "BoostCampaign", "ScaleBids",
    "ScaleBudget", "ScaleBudgets", "SetReserve", "BudgetPacing",
    "AddEntrant", "BidNoise", "ParticipationJitter", "MultiplierJitter",
    "ScenarioLane", "FamilyContext", "as_interventions",
    "CompiledFamily", "compile_family", "design_fingerprint",
    "family_fingerprint", "family_fingerprints", "grid_fingerprints",
    "ShapleyAttribution", "attribute", "shapley_values",
]
