"""Measured tuning: time the cost model's best candidates (port of
``repro.tune.measure``).

Every candidate is timed *paired against the default plan*, interleaved
(candidate, default, candidate, default, ...), and each side's median
kept, so drift in the machine's load hits both alike. The host clock times
each call, which ends in ``torch.cuda.synchronize()`` on the card.

The budget:

* the measurement runs on a truncated log (``values[:t]``, a view;
  ``max_events``): the round structure is driven by the shape, so the
  knobs' order carries over and each trial stays cheap;
* a quick pass (``quick_trials``) drops candidates slower than
  ``prune_ratio`` times the best so far before the full ``trials``;
* the winner must strictly beat the default in its paired measurement,
  else the default is recorded: a tuned plan is never slower than the
  default beyond the noise of the measurement.

Every candidate gives the same bits, so the order of measurement, the
pruning and even a wrong winner cost time only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.core import executor as ex
from repro_torch.core import segments as seg_lib
from repro_torch.launch.roofline import HardwareSpec
from repro_torch.tune import cache as cache_lib
from repro_torch.tune import space as space_lib
from repro_torch.tune.space import ProblemShape


@dataclasses.dataclass
class Measurement:
    """One candidate's paired timing (medians, microseconds)."""

    config: dict
    us: float
    us_default: float
    predicted_total: float
    pruned: bool = False        # dropped at the quick stage

    @property
    def ratio(self) -> float:
        return self.us / max(self.us_default, 1e-9)


@dataclasses.dataclass
class TuneReport:
    """What one tuning pass decided, measured and kept."""

    shape: ProblemShape
    key: str
    winner_config: dict
    origin: str                       # "measured" | "cost_model"
    us_tuned: Optional[float]
    us_default: Optional[float]
    measurements: List[Measurement]
    cache_path: Optional[str]
    n_candidates: int
    measured_events: int

    @property
    def speedup(self) -> Optional[float]:
        if self.us_tuned is None or self.us_default is None:
            return None
        return self.us_default / max(self.us_tuned, 1e-9)

    def plan(self, plan: ex.SweepPlan) -> ex.SweepPlan:
        """The concrete tuned plan for ``plan``'s pinned fields."""
        return space_lib.candidate_from_config(self.winner_config).apply(plan)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_pair(fn_a, fn_b, device, repeats: int = 15, warmup: int = 2):
    """Interleaved paired medians (µs) of two calls on ``device``: each
    call timed on the host clock up to a synchronize."""
    for _ in range(warmup):
        fn_a()
        fn_b()
    _sync(device)
    ta, tb = [], []
    for _ in range(repeats):
        for fn, ts in ((fn_a, ta), (fn_b, tb)):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            ts.append(time.perf_counter() - t0)
    med = lambda ts: sorted(ts)[len(ts) // 2] * 1e6
    return med(ta), med(tb)


def truncated_events(n_events: int, max_events: int) -> int:
    """The measured log's length: ``min(N, max_events)`` cut to whole
    canonical reduction blocks, so chunk candidates stay aligned."""
    t = min(int(n_events), int(max_events))
    return max(t - t % seg_lib.REDUCE_BLOCKS, 1)


def autotune(values, budgets, rules, plan: ex.SweepPlan, *,
             overlay=None,
             cache=None,
             cache_path=None,
             hw: Optional[HardwareSpec] = None,
             top_k: int = 4,
             trials: int = 7,
             quick_trials: int = 3,
             prune_ratio: float = 1.5,
             max_events: int = 4096,
             measure: bool = True,
             refine_with_hlo: bool = True) -> TuneReport:
    """One tuning pass of ``plan`` on this problem: the legal lattice,
    ranked by the cost model; the best ``top_k`` re-ranked by the counted
    work of their concrete plans (:func:`~repro_torch.tune.space.
    dryrun_terms`; ``refine_with_hlo``, ``repro``'s name); each timed
    paired against the default plan on the truncated log; the winner kept
    in the cache (``cache``, or the file at ``cache_path``, or the default
    file). ``measure=False`` stops after the cost model. The sweep runs
    where ``budgets`` live (``values``' device for a tensor log)."""
    n_events, n_campaigns = values.shape
    device = values.device if isinstance(values, torch.Tensor) \
        else budgets.device
    budgets = torch.as_tensor(budgets).to(device, torch.float32)
    n_scenarios = budgets.shape[0] if budgets.ndim == 2 else 1
    shape = space_lib.shape_for(plan, n_events=n_events,
                                n_campaigns=n_campaigns,
                                n_scenarios=n_scenarios, device=device)
    if hw is None:
        hw = HardwareSpec.for_backend(shape.platform)
    ranked = space_lib.rank_candidates(plan, shape, hw)
    candidates = [c for c, _ in ranked]
    predicted = {c: p.total for c, p in ranked}
    default = space_lib.default_candidate(plan)
    top = candidates[:max(int(top_k), 1)]
    if refine_with_hlo and len(top) > 1:
        refined = {}
        for c in top:
            terms = space_lib.dryrun_terms(c, plan, shape, hw)
            if terms is None:
                refined = None
                break
            refined[c] = max(terms.t_compute, terms.t_memory) \
                + terms.t_collective
        if refined:
            top = sorted(top, key=lambda c: (refined[c], c.sort_key()))

    measurements: List[Measurement] = []
    winner, origin = top[0], "cost_model"
    us_tuned = us_default = None
    t = truncated_events(n_events, max_events)
    if measure and top:
        if isinstance(values, ex.HostStream):
            v_meas = values if t == n_events else ex.HostStream(
                [values.chunk(0, t)])
        else:
            v_meas = values[:t]
        mshape = dataclasses.replace(shape, n_events=t)
        base_plan = default.apply(plan)

        def run(p):
            return lambda: ex.execute_sweep(v_meas, budgets, rules, p,
                                            overlay=overlay)

        base_fn = run(base_plan)
        best_us = None
        for cand in top:
            if cand == default:
                continue          # the default is the B side of every pair
            if not space_lib.is_legal(cand, plan, mshape):
                continue          # aligned on N but not on the truncation
            cand_fn = run(cand.apply(plan))
            us_c, us_d = _time_pair(cand_fn, base_fn, device,
                                    repeats=max(int(quick_trials), 1))
            pruned = best_us is not None and us_c > prune_ratio * best_us
            if not pruned and trials > quick_trials:
                us_c, us_d = _time_pair(cand_fn, base_fn, device,
                                        repeats=max(int(trials), 1))
            measurements.append(Measurement(
                config=cand.config(), us=us_c, us_default=us_d,
                predicted_total=predicted.get(cand, float("nan")),
                pruned=pruned))
            if not pruned and (best_us is None or us_c < best_us):
                best_us = us_c
        # the winner must strictly beat the default's paired time; ties and
        # losses keep the default
        best = None
        for m in measurements:
            if not m.pruned and m.ratio < 1.0 and (
                    best is None or m.ratio < best.ratio):
                best = m
        if best is not None:
            winner = space_lib.candidate_from_config(best.config)
            us_tuned, us_default = best.us, best.us_default
        else:
            # nothing beat the default: it is the decision, with the paired
            # time of the closest pair
            winner = default
            if measurements:
                m = min(measurements, key=lambda m: m.ratio)
                us_tuned = us_default = m.us_default
        origin = "measured"

    key = cache_lib.cache_key(shape)
    if cache is None:
        cache = cache_lib.TuningCache.load(cache_path)
    cache.put(key, winner.config(), origin=origin,
              us_tuned=us_tuned, us_default=us_default,
              hardware=hw.name, measured_events=t if measure else 0,
              shape=dataclasses.asdict(shape))
    path = str(cache.save())
    return TuneReport(
        shape=shape, key=key, winner_config=winner.config(), origin=origin,
        us_tuned=us_tuned, us_default=us_default,
        measurements=measurements, cache_path=path,
        n_candidates=len(candidates), measured_events=t if measure else 0)
