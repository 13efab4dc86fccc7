"""Compile an intervention family down to the sweep executor's inputs (port
of ``repro.scenarios.family``).

:func:`compile_family` takes a base design plus a list of scenario specs
(each a sequence of :mod:`~repro_torch.scenarios.interventions`) and lowers
them to
the three things the executor already understands:

* a (possibly extended) valuation matrix — base campaigns plus one shared
  column per distinct
  :class:`~repro_torch.scenarios.interventions.AddEntrant`
  slot;
* a :class:`~repro_torch.core.counterfactual.ScenarioGrid` of per-scenario
  design arrays (multipliers, reserves, budgets);
* an optional :class:`~repro_torch.core.types.ScenarioOverlay` carrying what
  a design cannot — per-scenario live windows and CRN stochastic axes.

Scenario 0 is always the untouched base design, so every family is its own
control: ``delta_table()`` rows and Shapley attributions are measured
against a lane that is *bitwise* the overlay-free base program (the
metamorphic contract of ``repro``'s tests/test_scenarios.py).

The compiler is deliberately eager about staying on the cheap path: a family
whose interventions are all design-only (boosts, scalings, reserves,
multiplier jitter) compiles to ``overlay=None`` — indistinguishable from a
hand-built grid, every estimator and warm start available. Live windows are
folded statically (``time_varying=False``) whenever every window is empty or
full, which keeps the kernel resolve back-ends eligible; only proper
sub-windows, bid noise, or participation jitter force the per-event
eligibility path (``resolve="torch"``).

The lanes are built by ``repro``'s numpy code and cast to float32/int32 the
same way, the fingerprints hash the same bytes (a key as its two uint32
words), so the port's family and its hex digests equal ``repro``'s for
the same inputs.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.counterfactual import ScenarioGrid
from repro_torch.core.types import AuctionRule, ScenarioOverlay
from repro_torch.scenarios.interventions import (AddEntrant, FamilyContext,
                                                 Intervention, ScenarioLane,
                                                 as_interventions)


@dataclasses.dataclass(frozen=True)
class CompiledFamily:
    """A scenario family lowered to executor inputs.

    ``values`` spans the extended campaign axis (base + entrant slots);
    ``grid`` / ``overlay`` are scenario-batched over it. Pass the family
    straight to
    :meth:`repro_torch.core.counterfactual.CounterfactualEngine.sweep` in
    place of a grid.
    """

    values: torch.Tensor                 # (N, C_total)
    grid: ScenarioGrid
    overlay: Optional[ScenarioOverlay]
    entrant_slots: dict                  # slot label -> extended column
    base_index: int = 0

    @property
    def num_scenarios(self) -> int:
        return self.grid.num_scenarios

    @property
    def num_entrants(self) -> int:
        return len(self.entrant_slots)

    @property
    def labels(self) -> Tuple[str, ...]:
        return self.grid.labels

    def fingerprints(self) -> Tuple[str, ...]:
        """Per-scenario canonical fingerprints — see
        :func:`family_fingerprints`."""
        return family_fingerprints(self)

    def fingerprint(self) -> str:
        """Whole-family canonical fingerprint — see
        :func:`family_fingerprint`."""
        return family_fingerprint(self)


# ---------------------------------------------------------------------------
# Canonical fingerprints (the service cache's scenario identity)
# ---------------------------------------------------------------------------

def _host(x):
    """A tensor's values as numpy (other arrays and scalars unchanged)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _canon(x, dtype) -> bytes:
    """Canonical bytes of an array: contiguous, fixed dtype, EXACT bits.

    No rounding anywhere — the service cache may only ever merge requests
    whose executed programs are bit-identical, and the executed program
    consumes exactly these float32/int32 values."""
    return np.ascontiguousarray(np.asarray(_host(x), dtype)).tobytes()


def _key_bytes(key) -> bytes:
    if key is None:
        return b"no-key"
    return _canon(key, np.uint32)          # the key's two uint32 words


def design_fingerprint(*, kind: str, multipliers, reserve, budgets,
                       extra: bytes = b"") -> str:
    """Canonical fingerprint of ONE scenario design.

    sha256 over the pricing ``kind`` and the exact float32 bytes of the
    design arrays (multipliers, reserve, budgets), plus optional ``extra``
    bytes (the per-scenario overlay row for families). Two designs share a
    fingerprint iff the sweep executor would run the bit-identical
    per-lane program for them, which is what makes the service cache key
    ``(log_version, fingerprint)`` sound.
    """
    h = hashlib.sha256()
    for part in (kind.encode(), b"|", _canon(multipliers, np.float32), b"|",
                 _canon(reserve, np.float32), b"|",
                 _canon(budgets, np.float32), b"|", extra):
        h.update(part)
    return h.hexdigest()


def _overlay_extras(overlay: Optional[ScenarioOverlay],
                    n_scenarios: int) -> list:
    """Per-scenario canonical bytes of the overlay rows (empty bytes for
    ``overlay=None`` — a design-only family fingerprints exactly like the
    equivalent hand-built grid)."""
    if overlay is None:
        return [b""] * n_scenarios
    rows = []
    fields = (("live_start", np.int32), ("live_stop", np.int32),
              ("bid_sigma", np.float32), ("part_prob", np.float32))
    shared = _key_bytes(overlay.key) + (b"tv" if overlay.time_varying
                                        else b"")
    arrs = {name: (None if getattr(overlay, name) is None
                   else np.asarray(_host(getattr(overlay, name))))
            for name, _ in fields}
    for s in range(n_scenarios):
        row = b"overlay|" + shared
        for name, dtype in fields:
            arr = arrs[name]
            row += (b"none" if arr is None else _canon(arr[s], dtype)) + b"|"
        rows.append(row)
    return rows


def grid_fingerprints(grid: ScenarioGrid,
                      overlay: Optional[ScenarioOverlay] = None
                      ) -> Tuple[str, ...]:
    """Per-scenario fingerprints of a grid (+ optional overlay rows)."""
    extras = _overlay_extras(overlay, grid.num_scenarios)
    mult = np.asarray(_host(grid.rules.multipliers))
    res = np.asarray(_host(grid.rules.reserve))
    buds = np.asarray(_host(grid.budgets))
    return tuple(
        design_fingerprint(kind=grid.rules.kind, multipliers=mult[s],
                           reserve=res[s], budgets=buds[s], extra=extras[s])
        for s in range(grid.num_scenarios))


def family_fingerprints(family: CompiledFamily) -> Tuple[str, ...]:
    """Per-scenario fingerprints of a :class:`CompiledFamily` — the design
    row plus the scenario's overlay row (live windows, CRN sigmas/probs and
    the family key they draw from)."""
    return grid_fingerprints(family.grid, family.overlay)


def family_fingerprint(family: CompiledFamily) -> str:
    """Whole-family fingerprint: the valuation matrix digest (entrant
    columns included), the entrant slot layout, and every scenario row."""
    h = hashlib.sha256()
    h.update(_canon(family.values, np.float32))
    h.update(repr(sorted(family.entrant_slots.items())).encode())
    h.update(str(family.base_index).encode())
    for fp in family_fingerprints(family):
        h.update(fp.encode())
    return h.hexdigest()


def _on(x, dtype, device) -> torch.Tensor:
    """``x`` cast by numpy to ``dtype`` (round to nearest, as ``jnp.asarray``
    casts), as a tensor on ``device``."""
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def _scenario_label(interventions: Sequence[Intervention]) -> str:
    return " + ".join(i.label() for i in interventions) if interventions \
        else "base"


def compile_family(
    values: torch.Tensor,                # (N, C) base valuation matrix
    budgets: torch.Tensor,               # (C,) base budgets
    rule: AuctionRule,                   # base design (single-scenario)
    scenarios: Sequence,                 # specs accepted by as_interventions
    *,
    key: Optional[torch.Tensor] = None,  # family CRN root key
    labels: Optional[Sequence[str]] = None,
    include_base: bool = True,
) -> CompiledFamily:
    """Lower intervention scenarios to a :class:`CompiledFamily`.

    ``scenarios`` is a sequence of scenario specs — each a single
    :class:`~repro_torch.scenarios.interventions.Intervention`, a sequence
    of them
    (applied in order), or the grid-axis dict sugar. With ``include_base``
    (default) an untouched base scenario is prepended at index 0, the
    comparison lane for delta tables and the metamorphic tests.

    ``key`` roots every CRN stream of the family
    (:mod:`repro_torch.core.crn`): bid noise, participation jitter, entrant
    values, multiplier jitter all derive from it, so two families with the
    same key share their random world draw-for-draw. Required iff any
    intervention is stochastic. The family's tensors live on ``values``'s
    device, and its draws run there.
    """
    values = torch.as_tensor(values)
    dev = values.device
    n_events, n_base = values.shape
    specs = [tuple(as_interventions(s)) for s in scenarios]
    if include_base:
        specs.insert(0, ())
    if not specs:
        raise ValueError("compile_family needs at least one scenario")

    # Allocate one extended column per distinct AddEntrant slot label, in
    # order of first appearance across the family.
    entrant_slots: dict = {}
    entrant_specs: dict = {}
    for spec in specs:
        for iv in spec:
            if isinstance(iv, AddEntrant):
                if iv.slot not in entrant_slots:
                    entrant_slots[iv.slot] = n_base + len(entrant_slots)
                    entrant_specs[iv.slot] = iv
    n_total = n_base + len(entrant_slots)
    ctx = FamilyContext(n_events=n_events, n_base=n_base, n_total=n_total,
                        entrant_slots=entrant_slots, key=key, device=dev)

    # One shared valuation column per slot (CRN: the same entrant sees the
    # same per-event values in every scenario it appears in).
    if entrant_slots:
        cols = [entrant_specs[slot].column_values(ctx)
                for slot in entrant_slots]
        values = torch.cat(
            [values, torch.stack(cols, dim=1).to(values.dtype)], dim=1)

    base_budgets = np.zeros((n_total,), np.float64)
    base_budgets[:n_base] = np.asarray(_host(budgets), np.float64)
    base_mult = np.zeros((n_total,), np.float64)
    base_mult[:n_base] = np.asarray(_host(rule.multipliers), np.float64)
    base_reserve = float(rule.reserve)

    lanes = []
    for spec in specs:
        lane = ScenarioLane(
            budgets=base_budgets.copy(),
            multipliers=base_mult.copy(),
            reserve=base_reserve,
            # base campaigns live for the whole log; entrant slots paused
            # until an AddEntrant opens their window
            live_start=np.zeros((n_total,), np.int64),
            live_stop=np.concatenate([
                np.full((n_base,), n_events, np.int64),
                np.zeros((len(entrant_slots),), np.int64)]),
            bid_sigma=np.zeros((n_total,), np.float64),
            part_prob=np.ones((n_total,), np.float64),
        )
        for iv in spec:
            iv.apply(lane, ctx)
        lanes.append(lane)

    stack = lambda field: np.stack([getattr(l, field) for l in lanes])
    start, stop = stack("live_start"), stack("live_stop")
    sigma, prob = stack("bid_sigma"), stack("part_prob")

    empty = stop <= start
    full = (start == 0) & (stop == n_events)
    windows_deviate = bool(np.any(~full))
    time_varying = bool(np.any(~empty & ~full))
    sigma_any = bool(np.any(sigma != 0.0))
    prob_any = bool(np.any(prob != 1.0))

    overlay = None
    if windows_deviate or sigma_any or prob_any:
        if (sigma_any or prob_any) and key is None:
            raise ValueError(
                "stochastic interventions (BidNoise / ParticipationJitter) "
                "draw from the family CRN streams; pass key= to "
                "compile_family")
        overlay = ScenarioOverlay(
            live_start=_on(start, np.int32, dev) if windows_deviate else None,
            live_stop=_on(stop, np.int32, dev) if windows_deviate else None,
            bid_sigma=_on(sigma, np.float32, dev) if sigma_any else None,
            part_prob=_on(prob, np.float32, dev) if prob_any else None,
            key=key if (sigma_any or prob_any) else None,
            time_varying=time_varying)

    rules = AuctionRule(
        multipliers=_on(stack("multipliers"), np.float32, dev),
        reserve=_on([l.reserve for l in lanes], np.float32, dev),
        kind=rule.kind)
    if labels is not None:
        labels = tuple(labels)
        if include_base:
            labels = ("base",) + labels
        if len(labels) != len(specs):
            raise ValueError(
                f"{len(labels)} labels for {len(specs)} scenarios")
    else:
        labels = tuple(_scenario_label(spec) for spec in specs)
    grid = ScenarioGrid(rules=rules,
                        budgets=_on(stack("budgets"), np.float32, dev),
                        labels=labels)
    return CompiledFamily(values=values, grid=grid, overlay=overlay,
                          entrant_slots=entrant_slots, base_index=0)
