"""Candidate lattice and cost-model ranking of :class:`SweepPlan` knobs
(port of ``repro.tune.space``).

The tuner sees a sweep as a *problem shape* — (N, C, S, placement, the
concrete resolve back-end, the log's residency) on a (platform, device
count) — and enumerates the knobs free to move without changing one output
bit (the executor's chunk-equivalence contracts):

* ``block_t`` — ``repro``'s Pallas event tile. No CUDA kernel of the port
  takes a tile (``csrc/lane_resolve.cuh``, ``csrc/round_fused.cu`` and
  ``csrc/segment_partials.cu`` fix theirs when compiled), so, as ``repro``
  does wherever no Pallas grid takes it, the lattice keeps the plan's
  value;
* ``events_per_chunk`` — chunk sizes that pass
  :func:`~repro_torch.core.executor.check_chunks`;
* ``scenarios_per_chunk`` — sizes that pass
  :func:`~repro_torch.core.executor.check_scenario_chunks`;
* ``prefetch`` — a host stream's copy overlap on or off;
* ``skip_retired`` — whether the CUDA fused round skips retired lanes'
  work (free where that kernel runs).

Candidates are ranked by a roofline cost model (:func:`predicted_cost`)
of the port's own launch schedule, under the platform's
:class:`~repro_torch.launch.roofline.HardwareSpec`, with the fused round's
shared-memory gate (:func:`round_fused_fits`: C against
``round_campaign_limits()``) as the hard feasibility filter on CUDA. On
the CPU no kernel takes a knob and the ranking is ``repro``'s, the port's
``"torch"`` back-end standing where ``repro``'s ``"jnp"`` stands.
:func:`dryrun_terms` counts the bytes and operations of a concrete plan's
launches instead of compiling it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import executor as ex
from repro_torch.core import segments as seg_lib
from repro_torch.launch.roofline import (HardwareSpec, RooflineTerms,
                                         terms_from_cost)

DEFAULT_BLOCK_T = ex.DEFAULT_BLOCK_T
# small torch launches of one round outside the kernels: the fold of the
# partials, lane_predict (on the two-pass shape) and lane_commit
ROUND_TORCH_OPS = 60
# torch launches of one lane's resolve on the torch back-end
LANE_RESOLVE_OPS = 10


@dataclasses.dataclass(frozen=True)
class ProblemShape:
    """The cache-key axes: what a tuned decision is conditioned on."""

    n_events: int
    n_campaigns: int
    n_scenarios: int
    platform: str = "cpu"          # the values' device type
    device_count: int = 1          # the mesh's devices (1 without a mesh)
    placement: str = "batched"
    resolve: str = "torch"         # concrete back-end (pick_resolve applied)
    source: str = "device"         # where the log lives


def shape_for(plan: ex.SweepPlan, *, n_events: int, n_campaigns: int,
              n_scenarios: int, device="cuda",
              limits: Optional[dict] = None) -> ProblemShape:
    """The :class:`ProblemShape` of ``plan`` and these sizes for a sweep on
    ``device`` (``limits`` as in :func:`~repro_torch.core.executor.
    pick_resolve`)."""
    dev = torch.device(device)
    return ProblemShape(
        n_events=int(n_events), n_campaigns=int(n_campaigns),
        n_scenarios=int(n_scenarios), platform=dev.type,
        device_count=(len(plan.mesh.mesh.devices) if plan.mesh is not None
                      else 1),
        placement=plan.placement,
        resolve=ex.pick_resolve(plan.resolve, dev, int(n_campaigns),
                                limits=limits),
        source=plan.chunks.source if plan.chunks is not None else "device")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the knob lattice; ``None`` chunk fields = unchunked."""

    block_t: int = DEFAULT_BLOCK_T
    events_per_chunk: Optional[int] = None
    scenarios_per_chunk: Optional[int] = None
    prefetch: bool = True
    skip_retired: bool = True

    def config(self) -> dict:
        """The JSON form the cache keeps (``repro``'s keys)."""
        return dataclasses.asdict(self)

    def sort_key(self) -> tuple:
        return (self.block_t, self.events_per_chunk or 0,
                self.scenarios_per_chunk or 0, not self.prefetch,
                not self.skip_retired)

    def apply(self, plan: ex.SweepPlan) -> ex.SweepPlan:
        """The concrete plan this candidate makes of ``plan``: only free
        knobs move, pinned fields pass through; ``tuned=False`` and an int
        ``block_t``."""
        free = free_knobs(plan)
        chunks = plan.chunks
        if free["chunks"] and self.events_per_chunk is not None:
            chunks = ex.ChunkSpec(self.events_per_chunk,
                                  prefetch=self.prefetch)
        elif free["prefetch"] and chunks is not None:
            chunks = dataclasses.replace(chunks, prefetch=self.prefetch)
        scen = plan.scenario_chunks
        if free["scenario_chunks"] and self.scenarios_per_chunk is not None:
            scen = ex.ScenarioChunkSpec(self.scenarios_per_chunk)
        return dataclasses.replace(
            plan,
            block_t=self.block_t if free["block_t"] else plan.block_t,
            skip_retired=(self.skip_retired if free["skip_retired"]
                          else plan.skip_retired),
            chunks=chunks, scenario_chunks=scen, tuned=False)


def candidate_from_config(config: dict) -> Candidate:
    """A :class:`Candidate` from its cached config (unknown keys, from a
    newer writer, are ignored; missing keys take the defaults)."""
    fields = {f.name for f in dataclasses.fields(Candidate)}
    return Candidate(**{k: v for k, v in config.items() if k in fields})


def free_knobs(plan: ex.SweepPlan) -> dict:
    """Which knobs the tuner may move for ``plan``: ``block_t="auto"``
    frees the tile; ``tuned=True`` also frees chunk specs left ``None``,
    a host ``ChunkSpec``'s ``prefetch`` and ``skip_retired``. A stated
    size is never moved (a service's append alignment may rest on it)."""
    return {
        "block_t": plan.block_t == "auto",
        "chunks": bool(plan.tuned) and plan.chunks is None,
        "scenario_chunks": bool(plan.tuned) and plan.scenario_chunks is None,
        "prefetch": bool(plan.tuned) and plan.chunks is not None
                    and plan.chunks.source == "host",
        "skip_retired": bool(plan.tuned),
    }


def default_candidate(plan: ex.SweepPlan) -> Candidate:
    """The incumbent: free knobs at the executor's defaults, pinned knobs
    at their values; its :meth:`Candidate.apply` is the untuned plan."""
    return Candidate(
        block_t=DEFAULT_BLOCK_T if plan.block_t == "auto" else plan.block_t,
        events_per_chunk=None,
        scenarios_per_chunk=None,
        prefetch=(plan.chunks.prefetch if plan.chunks is not None else True),
        skip_retired=plan.skip_retired)


def _skip_reaches_kernel(shape: ProblemShape) -> bool:
    """Whether ``skip_retired`` reaches a kernel: the CUDA fused round
    (``round_fused`` and ``sweep_partials``) takes it; no other back-end
    does."""
    return shape.platform == "cuda" and shape.resolve == "fused"


def _local_counts(plan: ex.SweepPlan, shape: ProblemShape
                  ) -> Tuple[int, int]:
    """(events, scenarios) per device under the plan's mesh (if any)."""
    local_n, local_s = shape.n_events, shape.n_scenarios
    if plan.mesh is not None:
        d_ev = plan.mesh.event_device_count
        d_sc = plan.mesh.scenario_device_count
        if d_ev and local_n % d_ev == 0:
            local_n //= d_ev
        if d_sc and local_s % d_sc == 0:
            local_s //= d_sc
    return local_n, local_s


def _chunk_sizes(n_events: int, local_n: int) -> List[int]:
    """Legal events_per_chunk values: divisors of the per-device count
    holding whole canonical reduction blocks, on the halving ladder."""
    block = seg_lib.reduce_block_size(n_events)
    sizes = []
    parts = 2
    while parts <= seg_lib.REDUCE_BLOCKS:
        epc, rem = divmod(local_n, parts)
        if rem == 0 and epc >= 1 and epc % block == 0:
            sizes.append(epc)
        parts *= 2
    return sizes


def _scenario_chunk_sizes(local_s: int) -> List[int]:
    """Legal scenarios_per_chunk values: proper divisors of the per-device
    lane count."""
    return [local_s // p for p in (2, 4, 8)
            if local_s % p == 0 and local_s // p >= 1]


def round_fused_fits(cand: Candidate, plan: ex.SweepPlan,
                     shape: ProblemShape, *,
                     limits: Optional[dict] = None) -> bool:
    """The hard gate, the counterpart of ``repro``'s VMEM filter: on CUDA
    a candidate on the fused back-end holds C campaigns in the fused
    round's shared memory (``limits["fused"]``, by default
    ``round_campaign_limits()``; S does not enter it). Elsewhere every
    candidate passes."""
    if shape.platform != "cuda" or shape.resolve != "fused":
        return True
    limit = (limits or {}).get("fused")
    return ex.round_fused_fits(cand.scenarios_per_chunk or shape.n_scenarios,
                               shape.n_campaigns, limit=limit)


def is_legal(cand: Candidate, plan: ex.SweepPlan, shape: ProblemShape, *,
             limits: Optional[dict] = None) -> bool:
    """The executor's own alignment checks and the shared-memory gate;
    builds the lattice and checks a cached config against the exact shape
    (buckets are coarser than shapes)."""
    free = free_knobs(plan)
    if not free["block_t"] and cand.block_t != plan.block_t:
        return False
    if not free["chunks"] and cand.events_per_chunk is not None:
        return False
    if not free["scenario_chunks"] and cand.scenarios_per_chunk is not None:
        return False
    local_n, local_s = _local_counts(plan, shape)
    try:
        if cand.events_per_chunk is not None:
            ex.check_chunks(ex.ChunkSpec(cand.events_per_chunk),
                            n_events=shape.n_events, local_n=local_n)
        if cand.scenarios_per_chunk is not None:
            ex.check_scenario_chunks(
                ex.ScenarioChunkSpec(cand.scenarios_per_chunk),
                n_scenarios=shape.n_scenarios, local_s=local_s)
    except ValueError:
        return False
    return round_fused_fits(cand, plan, shape, limits=limits)


def enumerate_candidates(plan: ex.SweepPlan, shape: ProblemShape, *,
                         limits: Optional[dict] = None) -> List[Candidate]:
    """The legal lattice in a fixed order, the incumbent first."""
    free = free_knobs(plan)
    local_n, local_s = _local_counts(plan, shape)
    base = default_candidate(plan)
    epcs: List[Optional[int]] = [None]
    if free["chunks"]:
        epcs += _chunk_sizes(shape.n_events, local_n)
    spcs: List[Optional[int]] = [None]
    if free["scenario_chunks"]:
        spcs += _scenario_chunk_sizes(local_s)
    prefetches = [True, False] if free["prefetch"] else [base.prefetch]
    skips = [base.skip_retired]
    if free["skip_retired"] and _skip_reaches_kernel(shape):
        skips = [True, False]
    out = []
    for epc in epcs:
        for spc in spcs:
            for pf in prefetches:
                for sk in skips:
                    cand = Candidate(base.block_t, epc, spc, pf, sk)
                    if is_legal(cand, plan, shape, limits=limits):
                        out.append(cand)
    out = sorted(set(out), key=Candidate.sort_key)
    if base in out:                      # incumbent first, the rest stable
        out.remove(base)
    return [base] + out


# -- the cost model ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PredictedCost:
    """Predicted seconds of one sweep: roofline terms plus overheads."""

    terms: RooflineTerms       # T_comp / T_mem / T_coll over the sweep
    t_h2d: float               # host-to-device copies left after overlap
    t_dispatch: float          # launch overhead
    total: float


@dataclasses.dataclass(frozen=True)
class _Work:
    flops: float
    nbytes: float
    wire: float
    launches: float
    h2d_bytes: float


def _sweep_work(cand: Candidate, plan: ex.SweepPlan, shape: ProblemShape,
                limits: Optional[dict] = None) -> _Work:
    """The operations, bytes, collective bytes, launches and host copies of
    one sweep under ``cand``, over ``min(C, 64) + 1`` rounds.

    On the CPU this is ``repro``'s model with no kernel: every round takes
    two passes, the values read once a pass and each lane's winners and
    prices written and read, one dispatch per pass and event and scenario
    chunk. On CUDA it follows the port's schedule: the fused back-end's
    one-launch round (``round_fused``) where C fits and nothing is chunked
    or sharded, else ``2 x n_chunks`` ``sweep_partials`` launches a round;
    the other back-ends resolve once a round (twice a chunk when chunked;
    the torch path a lane at a time, reading the values for each) and add
    two ``segment_partials`` launches a chunk; about
    :data:`ROUND_TORCH_OPS` small torch launches a round on every
    back-end, and every scenario chunk its own round loop."""
    local_n, local_s = _local_counts(plan, shape)
    c, s = shape.n_campaigns, local_s
    rounds = min(c, 64) + 1
    n_chunks = (local_n // cand.events_per_chunk
                if cand.events_per_chunk else 1)
    n_schunks = (s // cand.scenarios_per_chunk
                 if cand.scenarios_per_chunk else 1)
    values_bytes = local_n * c * 4.0
    partials_bytes = s * seg_lib.REDUCE_BLOCKS * c * 4.0 * 2
    chunked = cand.events_per_chunk is not None or plan.chunks is not None
    if shape.platform != "cuda":
        passes = 2
        flops = passes * s * local_n * c * 2.0
        nbytes = passes * (values_bytes + s * local_n * 4.0 * 2) \
            + partials_bytes
        launches = passes * n_chunks * n_schunks
        h2d = passes * values_bytes
    elif shape.resolve == "fused":
        one_launch = (not chunked and shape.source == "device"
                      and shape.placement not in ("sharded", "multihost")
                      and round_fused_fits(cand, plan, shape, limits=limits))
        passes = 1 if one_launch else 2
        flops = passes * s * local_n * c * 2.0
        if cand.skip_retired:
            flops *= 0.9            # retired lanes skipped, ~10% modelled
        nbytes = passes * values_bytes * n_schunks + partials_bytes
        launches = n_schunks * (passes * n_chunks + ROUND_TORCH_OPS)
        h2d = passes * values_bytes
    else:
        resolves = 2 if chunked else 1
        lane_reads = s if shape.resolve == "torch" else n_schunks
        flops = resolves * s * local_n * c * 2.0
        nbytes = (resolves * values_bytes * lane_reads
                  + (resolves + 2) * s * local_n * 8.0 + partials_bytes)
        per_resolve = (s * LANE_RESOLVE_OPS if shape.resolve == "torch"
                       else n_schunks)
        launches = (resolves * n_chunks * per_resolve
                    + n_schunks * (2 * n_chunks + ROUND_TORCH_OPS))
        h2d = resolves * values_bytes
    wire = 0.0
    if shape.placement in ("sharded", "multihost") and plan.mesh is not None:
        d = max(plan.mesh.event_device_count, 1)
        if d > 1:                   # ring all-reduce of the (S, G, C) partials
            wire = 2.0 * partials_bytes * (d - 1) / d
    return _Work(flops=flops * rounds, nbytes=nbytes * rounds,
                 wire=wire * rounds, launches=launches * rounds,
                 h2d_bytes=h2d * rounds if shape.source == "host" else 0.0)


def predicted_cost(cand: Candidate, plan: ex.SweepPlan, shape: ProblemShape,
                   hw: Optional[HardwareSpec] = None, *,
                   limits: Optional[dict] = None) -> PredictedCost:
    """Roofline cost of one sweep under ``cand``: ``max(T_comp, T_mem) +
    T_coll``, plus host copies at ``h2d_bw`` (a prefetched stream's mostly
    hidden behind the partials, modelled at 15%) and ``dispatch_us`` a
    launch (:func:`_sweep_work`). Every candidate gives the same bits, so
    only the ranking matters."""
    if hw is None:
        hw = HardwareSpec.for_backend(shape.platform)
    work = _sweep_work(cand, plan, shape, limits)
    terms = terms_from_cost(work.flops, work.nbytes, work.wire, hw)
    t_h2d = work.h2d_bytes / hw.h2d_bw * (0.15 if cand.prefetch else 1.0)
    t_dispatch = work.launches * hw.dispatch_us * 1e-6
    total = max(terms.t_compute, terms.t_memory) + terms.t_collective \
        + t_h2d + t_dispatch
    return PredictedCost(terms=terms, t_h2d=t_h2d, t_dispatch=t_dispatch,
                         total=total)


def rank_candidates(plan: ex.SweepPlan, shape: ProblemShape,
                    hw: Optional[HardwareSpec] = None,
                    candidates: Optional[Sequence[Candidate]] = None, *,
                    limits: Optional[dict] = None,
                    ) -> List[Tuple[Candidate, PredictedCost]]:
    """The lattice sorted by predicted cost; exact ties break on the knob
    tuple, so equal costs rank the same way every time."""
    if candidates is None:
        candidates = enumerate_candidates(plan, shape, limits=limits)
    scored = [(c, predicted_cost(c, plan, shape, hw, limits=limits))
              for c in candidates]
    return sorted(scored, key=lambda t: (t[1].total, t[0].sort_key()))


def dryrun_terms(cand: Candidate, plan: ex.SweepPlan, shape: ProblemShape,
                 hw: Optional[HardwareSpec] = None, *,
                 limits: Optional[dict] = None) -> Optional[RooflineTerms]:
    """The bytes and operations of the concrete plan's launches at
    ``shape``, counted from the launch schedule (:func:`_sweep_work`)
    rather than compiled, as roofline terms under ``hw``. ``None`` for
    host streams and multihost, as in ``repro``."""
    if shape.source == "host" or shape.placement == "multihost":
        return None
    if hw is None:
        hw = HardwareSpec.for_backend(shape.platform)
    concrete = cand.apply(plan)
    work = _sweep_work(default_candidate(concrete), concrete, shape, limits)
    return terms_from_cost(work.flops, work.nbytes, work.wire, hw)
