"""Plan tuning: the performance knobs of a :class:`SweepPlan` decided by
measurement and a cost model (port of ``repro.tune``).

``SweepPlan(block_t="auto")`` / ``SweepPlan(tuned=True)`` hand the plan's
free knobs (event and scenario chunk sizes, a host stream's prefetch, the
fused round's ``skip_retired``; ``block_t`` reaches no CUDA kernel) to this
package. :func:`~repro_torch.core.executor.execute_sweep` resolves them
before anything runs (:func:`resolve_plan`):

1. the persistent tuning cache (:mod:`repro_torch.tune.cache`): a measured
   winner at this (platform, device count, shape bucket, plan axes) key;
2. else the cost model's first candidate (:mod:`repro_torch.tune.space`):
   roofline terms of the port's launch schedule under the platform's
   :class:`~repro_torch.launch.roofline.HardwareSpec`, the fused round's
   shared memory a hard gate.

Measurements come only from :func:`repro_torch.tune.measure.autotune`
(interleaved paired medians against the default plan on a truncated log),
kept for every later sweep of the same shape. Every candidate gives the
default plan's bits (the executor's chunk-equivalence contracts), so a
stale or wrong entry costs time and never changes an answer.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core import executor as _ex
from repro_torch.tune.cache import (ENV_VAR, SCHEMA_VERSION, TuningCache,
                                    cache_key, default_cache_path,
                                    shared_cache)
from repro_torch.tune.measure import Measurement, TuneReport, autotune
from repro_torch.tune.space import (Candidate, ProblemShape,
                                    candidate_from_config, default_candidate,
                                    enumerate_candidates, free_knobs,
                                    is_legal, predicted_cost,
                                    rank_candidates, shape_for)

__all__ = [
    "autotune", "resolve_plan", "Candidate", "ProblemShape", "TuneReport",
    "Measurement", "TuningCache", "cache_key", "default_cache_path",
    "shared_cache", "candidate_from_config", "default_candidate",
    "enumerate_candidates", "free_knobs", "predicted_cost",
    "rank_candidates", "shape_for", "ENV_VAR", "SCHEMA_VERSION",
]


def resolve_plan(plan: _ex.SweepPlan, *, n_events: int, n_campaigns: int,
                 n_scenarios: int, device="cuda",
                 cache: Optional[TuningCache] = None) -> _ex.SweepPlan:
    """The concrete plan a tuned or ``block_t="auto"`` plan runs as on
    ``device`` (the cache, else the cost model; never a measurement). A
    concrete plan comes back as it is."""
    if not _ex.needs_tuning(plan):
        return plan
    dev = torch.device(device)
    if cache is None:
        return _resolve_shared(plan, int(n_events), int(n_campaigns),
                               int(n_scenarios), dev, _shared_cache_stamp())
    return _resolve(plan, int(n_events), int(n_campaigns), int(n_scenarios),
                    dev, cache)


def _shared_cache_stamp():
    """A token that changes when the default cache file does: the memo key
    that lets repeated same-shape resolutions skip the ranking and still
    see updates on disk."""
    p = Path(default_cache_path())
    try:
        st = p.stat()
        return (str(p), st.st_mtime_ns, st.st_size)
    except OSError:
        return (str(p), None, None)


@functools.lru_cache(maxsize=512)
def _resolve_shared(plan, n_events, n_campaigns, n_scenarios, device,
                    _stamp):
    return _resolve(plan, n_events, n_campaigns, n_scenarios, device,
                    shared_cache())


def _resolve(plan, n_events, n_campaigns, n_scenarios, device, cache):
    shape = shape_for(plan, n_events=n_events, n_campaigns=n_campaigns,
                      n_scenarios=n_scenarios, device=device)
    entry = cache.get(cache_key(shape))
    if entry is not None:
        cand = candidate_from_config(entry["config"])
        # buckets are coarser than shapes: check a cached winner against
        # the exact alignment contracts before trusting it
        if is_legal(cand, plan, shape):
            return cand.apply(plan)
    return rank_candidates(plan, shape)[0][0].apply(plan)
