"""The sweep executor: one Algorithm-2 program for every scenario lane (port
of ``repro.core.executor``).

A :class:`SweepPlan` names the axes of one execution and
:func:`execute_sweep` runs it:

* **placement** — ``"batched"`` (S lanes on one device) or ``"device"``
  (one unbatched lane, run as the batched program at S=1);
* **resolve** — the per-round back-end: ``"torch"`` (resolve with plain
  tensor ops, one lane at a time, then two windowed canonical partials of
  the same winners/prices), ``"sweep_resolve"`` (all lanes resolved at once
  by ``kernels.auction_resolve.ops.sweep_resolve``, then the same two
  partials; ``repro``'s ``"pallas"``), ``"fused"`` (the whole round through
  ``kernels.auction_resolve.ops.round_fused``), or ``"auto"`` (``"fused"``
  on CUDA, ``"torch"`` on the CPU — :func:`pick_resolve`; on CUDA a C
  above a kernel back-end's shared memory takes :data:`ANY_C_BACKEND`,
  every lane of a round resolved by one ``auction_resolve`` launch). Each
  kernel wrapper launches its hand-written CUDA kernel for CUDA tensors
  and runs its plain version for CPU tensors; the partials go through
  :func:`repro_torch.core.segments.window_partials`, event-ordered on both;
* **skip_retired** — whether the CUDA round skips frozen lanes' work.

Every reduction goes through the canonical ``(S, 32, C)`` block partials
and the in-order fold of :mod:`repro_torch.core.segments`, and the per-lane
arithmetic (:func:`lane_predict` / :func:`lane_commit`) repeats
``repro``'s operation for operation, so on the CPU the port reproduces
``repro``'s ``execute_sweep`` outputs bit for bit, and on the card every
back-end gives the CPU's bits.

The SORT2AGGREGATE sweep has its own entry, :func:`execute_s2a_sweep`
(validated by :func:`check_s2a_options`): every lane refined and
aggregated by :func:`repro_torch.core.sort2aggregate.refine_fixed_lanes`.

Two axes bound the memory of a round, as in ``repro``:

* **chunks** — event chunks (:class:`ChunkSpec`, ``source="device"``):
  every round takes the two-pass shape, each pass a loop over the chunks
  in order that adds each chunk's ``(S, 32, C)`` partials, its rows placed
  on the global grid at ``offset = k·events_per_chunk`` (one
  ``sweep_partials`` launch a chunk on the fused back-end; a resolve of
  the chunk's rows and one ``segment_partials`` launch on the others).
  Every canonical block belongs to exactly one chunk, so the sum adds
  exact zeros and the bits are the unchunked sweep's; the per-event
  winners and prices are (S, events_per_chunk), not (S, N).
* **scenario_chunks** — scenario chunks (:class:`ScenarioChunkSpec`):
  the round body and loop run for each slice of the lanes in turn and the
  results are concatenated. Lanes never read each other, so the bits are
  the unchunked sweep's.

Both must align (:func:`check_chunks`, :func:`check_scenario_chunks`,
``repro``'s error texts).

A :class:`~repro_torch.core.types.ScenarioOverlay` (the lowering target
of :mod:`repro_torch.scenarios`) threads through the round body as in
``repro`` (:func:`check_overlay`): static live windows fold into the
activation mask every back-end sees; per-event overlays (bid noise,
participation, time-varying windows) take the ``"torch"`` back-end, which
perturbs each lane's rows by the CRN draws of their global events
(:func:`_overlay_noise`, drawn once a sweep) and masks them before it
resolves; event chunks slice the draws, scenario chunks the overlay.

The log may also live in host memory (:class:`HostStream`, or
``ChunkSpec(source="host")``): every pass then streams it chunk by chunk
through two device buffers, the copies on a stream of their own
(:class:`_HostPipeline`), and runs the same per-chunk program as the
device-resident chunk loop, so the bits are the device-resident sweep's.

A resumable fold (:func:`execute_sweep_resumable`) runs the round program
over NEW rows only, from a carried :class:`SweepCarry`, the rows placed on
the global grid at the rows already seen: the streaming service's causal
estimate (:mod:`repro_torch.serve.counterfactual`).

Two placements spread the log over a mesh
(:class:`repro_torch.launch.mesh.SweepMeshSpec`), as in ``repro``:

* ``"sharded"`` — one process: event rank ``r`` holds global events
  ``[r·local_n, (r+1)·local_n)`` on its mesh device (views of one tensor
  where devices repeat, as on one card). Every round takes the two-pass
  shape on every back-end where the fused kernel would run one launch
  (``repro`` runs no one-launch round when sharded); each shard's
  ``(S, 32, C)`` partials are computed on its device at its global offset
  and added on the budgets' device in rank order — the psum, exact because
  each canonical block is one shard's and the others add +0.0. Chunks ×
  sharding scans each shard's own chunks; a scenario axis runs each
  scenario group's lanes through their own loop, the results gathered in
  lane order (lanes never read each other, so the bits are those of one
  loop over all lanes).
* ``"multihost"`` — a ``torch.distributed`` world, one event shard a rank:
  each rank passes its own rows, and each pass's partials go through one
  ``all_reduce(SUM)`` (:data:`COLLECTIVES` counts them); the outputs are
  replicated on every rank.

A plan's performance knobs may be left to the tuner (:mod:`repro_torch.
tune`), as in ``repro``: ``block_t="auto"`` and ``tuned=True`` resolve in
:func:`execute_sweep`, before anything runs (:func:`resolve_auto_plan`:
the tuning cache, else the cost model; never a measurement), to a concrete
plan whose outputs are the default plan's bit for bit. ``block_t`` is
``repro``'s Pallas event tile; the port's CUDA kernels fix their tiles when
they are compiled, so the tuner keeps it at the plan's value.

The round loop (:func:`_run_loop`) is a Python loop that checks once per
round whether any lane is alive — one host sync per round; capturing the
loop in a CUDA graph is later work. The port names its resolve back-ends
after what they run, so ``repro``'s ``"jnp"`` and ``"pallas"`` are unknown
options here.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

import torch

from repro_torch.core import auction, crn
from repro_torch.core import segments as seg_lib
from repro_torch.core.sort2aggregate import (refine_fixed_chunked,
                                              refine_fixed_lanes)
from repro_torch.core.types import (AuctionRule, ScenarioOverlay,
                                    never_capped)
from repro_torch.device import DeviceLike, pick_device
from repro_torch.kernels import crn as crn_ops
from repro_torch.kernels.auction_resolve import ops as resolve_ops
from repro_torch.launch.mesh import (ShardedLog, SweepMeshSpec,
                                     ragged_shard_error)

RESOLVE_BACKENDS = ("torch", "sweep_resolve", "fused")
# the CUDA back-end of a C above the round kernels' shared memory; chosen by
# pick_resolve, never named by a caller
ANY_C_BACKEND = "auction_resolve"
SWEEP_DRIVERS = ("batched", "sharded", "multihost")
SIM_DRIVERS = ("auto", "device", "host")
PLACEMENTS = ("device", "batched", "sharded", "multihost")
CHUNK_SOURCES = ("device", "host")

DEFAULT_BLOCK_T = 256


def _unknown(kind: str, got, known) -> ValueError:
    """THE unknown-option error, with ``repro``'s message text."""
    names = ", ".join(repr(k) for k in known)
    return ValueError(f"unknown {kind}: {got!r} (choose from {names})")


def pick_resolve(resolve: str, device, n_campaigns: int | None = None, *,
                 limits: dict | None = None) -> str:
    """Resolve ``"auto"`` to a concrete back-end for tensors on ``device``:
    the CUDA fused round on CUDA, the plain torch path on the CPU.

    On CUDA, given ``n_campaigns``, a kernel back-end whose shared memory
    cannot hold C campaigns (``limits``, by default
    ``resolve_ops.round_campaign_limits()``), whether asked for or picked by
    ``"auto"``, gives way to :data:`ANY_C_BACKEND`, as ``repro``'s fused
    gate falls back to two passes: every lane resolved by one
    ``auction_resolve`` launch a round, which takes any C, and the
    partials by ``segment_partials``, both in event order, so it gives the
    other back-ends' bits."""
    if resolve == "auto":
        resolve = "fused" if torch.device(device).type == "cuda" else "torch"
    elif resolve not in RESOLVE_BACKENDS:
        raise _unknown("resolve back-end", resolve,
                       RESOLVE_BACKENDS + ("auto",))
    if (resolve != "torch" and n_campaigns is not None
            and torch.device(device).type == "cuda"):
        limits = resolve_ops.round_campaign_limits() if limits is None \
            else limits
        if n_campaigns > limits[resolve]:
            return ANY_C_BACKEND
    return resolve


@dataclasses.dataclass(frozen=True)
class ChunkSpec:
    """Event-chunked execution: every round scans the log
    ``events_per_chunk`` events at a time, adding each chunk's canonical
    ``(S, 32, C)`` partials (its rows placed on the global grid at the
    chunk's offset), so the per-event winners and prices exist for one
    chunk at a time: (S, events_per_chunk), not (S, N). Bit for bit the
    unchunked sweep for any aligned size (:func:`check_chunks`).

    ``source="device"`` scans a log on the card. ``source="host"`` streams
    it from host memory (:class:`HostStream`) through two device buffers a
    chunk at a time, so the card holds two chunks of the log and N is bound
    by host memory. ``prefetch=True`` overlaps chunk k+1's copy, on a
    stream of its own, with chunk k's partials; ``prefetch=False`` copies,
    then computes, one chunk after another (the baseline). Both run the
    same per-chunk program, so both give the device-resident sweep's
    bits."""

    events_per_chunk: int
    source: str = "device"
    prefetch: bool = True

    def __post_init__(self):
        if self.events_per_chunk < 1:
            raise ValueError(
                f"ChunkSpec.events_per_chunk must be >= 1, got "
                f"{self.events_per_chunk}")
        if self.source not in CHUNK_SOURCES:
            raise _unknown("chunk source", self.source, CHUNK_SOURCES)


def as_chunk_spec(chunks) -> Optional[ChunkSpec]:
    """Normalise ``None`` | int | :class:`ChunkSpec` to an optional spec."""
    if chunks is None or isinstance(chunks, ChunkSpec):
        return chunks
    return ChunkSpec(events_per_chunk=int(chunks))


@dataclasses.dataclass(frozen=True)
class ScenarioChunkSpec:
    """Scenario-chunked execution: the round body and the round loop run
    for ``scenarios_per_chunk`` lanes at a time, one slice after another.
    Lanes never read each other's state (a finished lane is frozen by a
    select), so this is bit for bit the unchunked sweep for any size that
    divides S (:func:`check_scenario_chunks`); per-round intermediates
    shrink from O(S·…) to O(scenarios_per_chunk·…)."""

    scenarios_per_chunk: int

    def __post_init__(self):
        if self.scenarios_per_chunk < 1:
            raise ValueError(
                f"ScenarioChunkSpec.scenarios_per_chunk must be >= 1, got "
                f"{self.scenarios_per_chunk}")


def as_scenario_chunk_spec(scenario_chunks) -> Optional[ScenarioChunkSpec]:
    """Normalise ``None`` | int | :class:`ScenarioChunkSpec`."""
    if scenario_chunks is None or isinstance(scenario_chunks,
                                             ScenarioChunkSpec):
        return scenario_chunks
    return ScenarioChunkSpec(scenarios_per_chunk=int(scenario_chunks))


class HostStream:
    """An event log in host memory: float32 CPU slabs (n_i, C), streamed to
    the card a chunk at a time.

    The slabs are kept as given (the service's append slabs) and never
    concatenated. Where CUDA is present they are pinned (a slab that is not
    is copied once into pinned memory), so a chunk's copy to the card is
    asynchronous. :meth:`chunk` gives rows ``[start, stop)``: a view of one
    slab when the window lies inside it, else the pieces put together in
    ``out`` (a pinned staging buffer) or a new tensor."""

    def __init__(self, slabs):
        slabs = [torch.as_tensor(s, dtype=torch.float32) for s in slabs]
        if not slabs:
            raise ValueError("HostStream needs at least one event slab")
        n_campaigns = slabs[0].shape[1] if slabs[0].ndim == 2 else -1
        for s in slabs:
            if s.ndim != 2 or s.shape[1] != n_campaigns or s.shape[0] < 1:
                raise ValueError(
                    "HostStream slabs must be non-empty (n, C) valuation "
                    f"blocks with one shared C; got shapes "
                    f"{[tuple(x.shape) for x in slabs]}")
        self._slabs = [host_slab(s) for s in slabs]
        self._starts = [0]
        for s in self._slabs:
            self._starts.append(self._starts[-1] + s.shape[0])

    @classmethod
    def from_array(cls, values) -> "HostStream":
        """Wrap an in-memory (N, C) log, copied to host memory once."""
        return cls([torch.as_tensor(values).detach().cpu()])

    @property
    def shape(self):
        return (self._starts[-1], self._slabs[0].shape[1])

    @property
    def ndim(self) -> int:
        return 2

    @property
    def n_events(self) -> int:
        return self._starts[-1]

    @property
    def n_campaigns(self) -> int:
        return self._slabs[0].shape[1]

    def straddles(self, start: int, stop: int) -> bool:
        """Whether rows ``[start, stop)`` span more than one slab."""
        i = bisect.bisect_right(self._starts, start) - 1
        return stop > self._starts[i + 1]

    def chunk(self, start: int, stop: int,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rows ``[start, stop)``: a view of one slab when the window lies
        inside it (always so when the slabs hold whole chunks), else the
        pieces put together in a new tensor. With ``out``, the rows are
        written into ``out[:stop - start]``, which is returned."""
        if not 0 <= start < stop <= self.n_events:
            raise ValueError(
                f"chunk window [{start}, {stop}) outside the stream's "
                f"{self.n_events} events")
        i = bisect.bisect_right(self._starts, start) - 1
        pieces = []
        while start < stop:
            s0 = self._starts[i]
            slab = self._slabs[i]
            take = min(stop, s0 + slab.shape[0])
            pieces.append(slab[start - s0:take - s0])
            start = take
            i += 1
        if out is not None:
            return torch.cat(pieces, out=out[:sum(p.shape[0] for p in pieces)])
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def host_slab(slab: torch.Tensor) -> torch.Tensor:
    """A slab in host memory, contiguous, and pinned where CUDA is
    present."""
    slab = slab.detach().cpu().contiguous()
    if torch.cuda.is_available() and not slab.is_pinned():
        slab = slab.pin_memory()
    return slab


def check_append_alignment(chunks: Optional[ChunkSpec], n_new: int) -> None:
    """The append-side chunk contract: a slab appended to a growing log
    holds whole chunks. Raises :func:`check_chunks`' "ragged chunk" text
    (``repro``'s); the block-alignment branch is a property of the whole
    log at sweep time, so the check builds an ``n_events`` whose block is
    the chunk and only the ragged branch can fire."""
    if chunks is None:
        return
    check_chunks(chunks,
                 n_events=chunks.events_per_chunk * seg_lib.REDUCE_BLOCKS,
                 local_n=n_new)


def check_host_stream(plan: "SweepPlan", *,
                      overlay: Optional[ScenarioOverlay] = None) -> None:
    """The host-streamed execution contract, with ``repro``'s texts: an
    explicit chunk size, a one-device placement, no scenario chunks, no
    overlay. Alignment itself is :func:`check_chunks`."""
    if plan.chunks is None:
        raise ValueError(
            "host-streamed execution needs chunks=: the log is fed to the "
            "device one chunk at a time, so ChunkSpec(events_per_chunk=..., "
            "source='host') (or an aligned int chunk size alongside a "
            "HostStream log) must state the working-set size.")
    if plan.placement not in ("device", "batched"):
        raise ValueError(
            "host-streamed chunks run placement='device'/'batched' only "
            f"(the host feeds one device's pipeline), got "
            f"{plan.placement!r}; device-resident logs scale out via "
            "placement='sharded'/'multihost' instead.")
    if plan.scenario_chunks is not None:
        raise ValueError(
            "scenario_chunks= does not compose with host-streamed chunks; "
            "drop scenario_chunks= (the host pipeline already bounds "
            "per-round intermediates by the event chunk).")
    if overlay is not None:
        raise ValueError(
            "overlays are not supported with host-streamed chunks; replay "
            "overlay families from a device-resident log "
            "(ChunkSpec(source='device') bounds their per-event "
            "intermediates the same way).")


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Everything that decides which Algorithm-2 program runs:
    ``placement`` (``"batched"`` | ``"device"`` | ``"sharded"`` |
    ``"multihost"``; the last two need ``mesh``, a
    :class:`repro_torch.launch.mesh.SweepMeshSpec`), ``resolve``
    (``"torch"`` | ``"sweep_resolve"`` | ``"fused"`` | ``"auto"``),
    ``skip_retired``, ``chunks`` (an optional :class:`ChunkSpec`, or an
    int), ``scenario_chunks`` (an optional :class:`ScenarioChunkSpec`, or
    an int), ``block_t`` (``repro``'s Pallas event tile, a positive int,
    or ``"auto"`` to leave it to the tuner; no CUDA kernel of the port
    takes it) and ``tuned`` (leave every knob not pinned here to the
    tuner: the tile when ``"auto"``, the chunk specs when ``None``, a host
    stream's prefetch, ``skip_retired``; :func:`resolve_auto_plan`)."""

    placement: str = "batched"
    resolve: str = "auto"
    skip_retired: bool = True
    mesh: Optional[SweepMeshSpec] = None
    chunks: Optional[ChunkSpec] = None
    scenario_chunks: Optional[ScenarioChunkSpec] = None
    block_t: int | str = DEFAULT_BLOCK_T
    tuned: bool = False

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise _unknown("placement", self.placement, PLACEMENTS)
        if self.block_t != "auto" and (
                not isinstance(self.block_t, int)
                or isinstance(self.block_t, bool) or self.block_t < 1):
            raise ValueError(
                f"SweepPlan.block_t must be a positive int or 'auto', got "
                f"{self.block_t!r}")
        if self.resolve not in RESOLVE_BACKENDS + ("auto",):
            raise _unknown("resolve back-end", self.resolve,
                           RESOLVE_BACKENDS + ("auto",))
        if self.placement in ("sharded", "multihost") and self.mesh is None:
            raise ValueError(
                f"placement={self.placement!r} needs mesh=SweepMeshSpec(...);"
                " see repro_torch.launch.mesh.SweepMeshSpec.for_devices "
                "(sharded) / .for_processes (multihost)")
        object.__setattr__(self, "chunks", as_chunk_spec(self.chunks))
        object.__setattr__(self, "scenario_chunks",
                           as_scenario_chunk_spec(self.scenario_chunks))


def plan_for_driver(driver: str, *, resolve: str = "auto",
                    skip_retired: bool = True, mesh=None, chunks=None,
                    scenario_chunks=None, block_t=DEFAULT_BLOCK_T,
                    tuned: bool = False) -> SweepPlan:
    """The plan of a ``driver=`` string (``sweep_parallel``,
    ``engine.sweep``, ``engine.search``), with ``repro``'s unknown-driver
    and missing-mesh texts; ``mesh`` is dropped off the mesh drivers."""
    if driver not in SWEEP_DRIVERS:
        raise _unknown("sweep driver", driver, SWEEP_DRIVERS)
    meshed = driver in ("sharded", "multihost")
    if meshed and mesh is None:
        raise ValueError(
            f"driver={driver!r} needs mesh=SweepMeshSpec(...); see "
            "repro_torch.launch.mesh.SweepMeshSpec.for_devices (sharded) / "
            ".for_processes (multihost)")
    return SweepPlan(placement=driver, resolve=resolve,
                     skip_retired=skip_retired,
                     mesh=mesh if meshed else None, chunks=chunks,
                     scenario_chunks=scenario_chunks, block_t=block_t,
                     tuned=tuned)


def needs_tuning(plan: SweepPlan) -> bool:
    """Whether the plan leaves knobs to the tuner."""
    return plan.tuned or plan.block_t == "auto"


def resolve_auto_plan(plan: SweepPlan, *, n_events: int, n_campaigns: int,
                      n_scenarios: int, device="cuda") -> SweepPlan:
    """``block_t="auto"`` / ``tuned=True`` resolved to a concrete plan for
    a sweep on ``device`` (:func:`repro_torch.tune.resolve_plan`: the
    tuning cache, else the cost model). A concrete plan comes back as it
    is. Only knobs whose every setting gives the same bits move."""
    if not needs_tuning(plan):
        return plan
    from repro_torch import tune
    return tune.resolve_plan(plan, n_events=n_events,
                             n_campaigns=n_campaigns,
                             n_scenarios=n_scenarios, device=device)


def _untuned(plan: SweepPlan) -> SweepPlan:
    """The tuner's knobs pinned at the defaults without asking the tuner:
    the entry points whose lattice it does not model (the SORT2AGGREGATE
    spine, resumable folds)."""
    if not needs_tuning(plan):
        return plan
    return dataclasses.replace(
        plan, block_t=DEFAULT_BLOCK_T if plan.block_t == "auto"
        else plan.block_t, tuned=False)


def check_chunks(chunks: Optional[ChunkSpec], *, n_events: int,
                 local_n: int) -> None:
    """The chunk-alignment contract, with ``repro``'s texts: a chunk holds
    whole canonical reduction blocks (so each block of the ``(32, C)``
    partials belongs to exactly one chunk and adding the chunks' partials
    adds exact zeros) and divides the event count (every chunk is full)."""
    if chunks is None:
        return
    epc = chunks.events_per_chunk
    block = seg_lib.reduce_block_size(n_events)
    g = seg_lib.REDUCE_BLOCKS
    if epc % block != 0:
        raise ValueError(
            f"chunk/grid misalignment: ChunkSpec(events_per_chunk={epc}) "
            f"does not hold whole canonical reduction blocks of {block} "
            f"events (N={n_events}, REDUCE_BLOCKS={g}); chunks must cover "
            "whole blocks for the bit-for-bit reduction contract. Use a "
            f"chunk size that is a multiple of {block}, pad N so the block "
            "size divides your chunk, or drop chunks=.")
    if local_n % epc != 0:
        raise ValueError(
            f"ragged chunk: {local_n} events per device do not divide into "
            f"chunks of {epc} (remainder {local_n % epc}). Pad the event "
            "log so every chunk is full (zero-valuation events never win, "
            "but they DO count toward rate denominators — pad the log "
            "upstream where that is accounted for), pick a chunk size that "
            "divides the per-device event count, or drop chunks=.")


def check_scenario_chunks(scenario_chunks: Optional[ScenarioChunkSpec], *,
                          n_scenarios: int, local_s: int) -> None:
    """The scenario-chunk contract, with ``repro``'s text: chunks divide
    the scenario count (lanes are independent, so that is all)."""
    if scenario_chunks is None:
        return
    spc = scenario_chunks.scenarios_per_chunk
    if local_s % spc != 0:
        raise ValueError(
            f"ragged scenario chunk: {local_s} scenarios per device do not "
            f"divide into chunks of {spc} (remainder {local_s % spc}). Pad "
            "the grid with repeats of the base design (duplicate lanes run "
            "the identical per-lane program, so they cannot change any "
            "other lane's bits), pick a scenario-chunk size that divides "
            "the per-device scenario count, or drop scenario_chunks=.")


# ---------------------------------------------------------------------------
# The fused round's gate: the resolve core's shared memory, not TPU VMEM
# ---------------------------------------------------------------------------

def round_fused_fits(n_scenarios: int, n_campaigns: int, *,
                     limit: Optional[int] = None) -> bool:
    """Whether the one-launch fused round (``round_fused``) holds C
    campaigns: ``C <= limit``, by default the resolve core's own shared
    memory (``rf_max_campaigns()``, ``csrc/round_fused.cu``: a work item
    holds at least one lane's C-wide rows, ``rf_item_lanes(C) > 0``).

    ``repro`` gates on a TPU VMEM budget that grows with S; on the H100 S
    does not enter the gate: a work item takes at most 8 lanes, and the
    ``(S, 32, C)`` partials live in device memory. So every S fits when C
    fits, and when C does not fit no scenario chunk does
    (:func:`pick_resolve` then sends the sweep to :data:`ANY_C_BACKEND`).
    ``n_scenarios`` is taken for ``repro``'s signature."""
    del n_scenarios
    limit = resolve_ops.round_campaign_limits()["fused"] if limit is None \
        else limit
    return n_campaigns <= limit


def fitting_scenario_chunk(n_scenarios: int, n_campaigns: int, *,
                           limit: Optional[int] = None) -> Optional[int]:
    """The largest divisor of ``n_scenarios`` whose fused round fits
    (:func:`round_fused_fits`), ``None`` when even one lane does not fit.
    On the H100 that is ``n_scenarios`` or ``None``."""
    for spc in range(n_scenarios, 0, -1):
        if n_scenarios % spc == 0 and \
                round_fused_fits(spc, n_campaigns, limit=limit):
            return spc
    return None


def planned_scenario_chunk(plan: SweepPlan, n_scenarios: int,
                           n_campaigns: int, resolve: Optional[str] = None,
                           *, device="cuda",
                           limit: Optional[int] = None) -> Optional[int]:
    """The scenario-chunk size ``plan`` runs at (``None`` = all lanes at
    once). An explicit ``plan.scenario_chunks`` always wins. Otherwise, as
    in ``repro``, a chunk is picked only where the fused one-launch round
    would run its kernel (CUDA, unsharded, no event chunks) and the whole
    batch does not fit its gate; on the H100 the gate does not depend on S
    (:func:`round_fused_fits`), so this never picks one. It picks nothing
    of its own either: ``repro`` has no memory-based pick."""
    if plan.scenario_chunks is not None:
        return plan.scenario_chunks.scenarios_per_chunk
    resolve = pick_resolve(plan.resolve, device) if resolve is None \
        else resolve
    if (resolve == "fused" and torch.device(device).type == "cuda"
            and plan.placement != "sharded" and plan.chunks is None
            and not round_fused_fits(n_scenarios, n_campaigns,
                                     limit=limit)):
        return fitting_scenario_chunk(n_scenarios, n_campaigns, limit=limit)
    return None


def check_sim_driver(driver: str) -> str:
    """Validate a single-scenario ``parallel_simulate`` driver string."""
    if driver not in SIM_DRIVERS:
        raise _unknown("driver", driver, SIM_DRIVERS)
    return driver


def check_batch_shapes(values, budgets, rules) -> None:
    """The (S, C)-batch contract shared by every sweep entry point."""
    if rules.multipliers.ndim != 2 or budgets.ndim != 2:
        raise ValueError(
            "sweep inputs must be batched: multipliers/budgets (S, C), "
            f"got {tuple(rules.multipliers.shape)} / {tuple(budgets.shape)}")
    n_campaigns = values.shape[1]
    if budgets.shape[1] != n_campaigns or \
            rules.multipliers.shape != budgets.shape:
        raise ValueError(
            f"scenario batch mismatch: values C={n_campaigns}, multipliers "
            f"{tuple(rules.multipliers.shape)}, budgets "
            f"{tuple(budgets.shape)}")
    # a host-streamed log is computed on where the budgets are
    where, dev = (("budgets", budgets.device) if isinstance(values, HostStream)
                  else ("values", values.device))
    for name, t in (("budgets", budgets), ("multipliers", rules.multipliers),
                    ("reserve", rules.reserve)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device} but {where} are on "
                             f"{dev}; put a sweep on one device")


def check_shard_layout(n_events: int, n_scenarios: int,
                       spec: SweepMeshSpec,
                       require_block_alignment: bool = True) -> None:
    """The shard contract of :func:`check_sharded_shapes` on the global
    shape alone (a multihost rank sees only its own rows)."""
    d_ev = spec.event_device_count
    if n_events % d_ev != 0:
        raise ragged_shard_error(n_events, d_ev)
    block = seg_lib.reduce_block_size(n_events)
    local_n = n_events // d_ev
    if require_block_alignment and d_ev > 1 and local_n % block != 0:
        if seg_lib.REDUCE_BLOCKS % d_ev != 0:
            # no N can align: shards can never hold whole canonical blocks
            raise ValueError(
                f"shard/grid misalignment: {d_ev} event-axis devices cannot "
                f"divide the canonical reduction grid (REDUCE_BLOCKS="
                f"{seg_lib.REDUCE_BLOCKS}); the event-device count must "
                "divide REDUCE_BLOCKS for the bit-for-bit contract. Use a "
                "device count that divides it, raise "
                "repro_torch.core.segments.REDUCE_BLOCKS (a repo-wide "
                "constant — it regroups every driver's reductions "
                "consistently, so the cross-driver bit-for-bit contract is "
                "preserved but absolute low bits shift), or use "
                "driver='batched'.")
        g = seg_lib.REDUCE_BLOCKS
        aligned_n = max(1, -(-n_events // g)) * g   # d_ev | g => d_ev | k*g
        raise ValueError(
            f"shard/grid misalignment: each shard holds {local_n} events but "
            f"the canonical reduction grid uses blocks of {block} "
            f"(REDUCE_BLOCKS={g}); shards must hold whole blocks for the "
            f"bit-for-bit reduction contract. Pad N to a multiple of {g} "
            f"(e.g. {aligned_n}), or use driver='batched'.")
    d_sc = spec.scenario_device_count
    if n_scenarios % d_sc != 0:
        raise ValueError(
            f"ragged scenario shard: S={n_scenarios} scenarios over {d_sc} "
            f"devices on mesh axis {spec.scenario_axis!r}. Pad the grid with "
            "repeats of the base design, or drop scenario_axis.")


def check_sharded_shapes(values, budgets, rules, spec: SweepMeshSpec,
                         require_block_alignment: bool = True) -> None:
    """The batch contract and the shard contract, with ``repro``'s texts:
    N divides over the event ranks; with ``require_block_alignment`` (the
    sharded Algorithm-2 sweep's bit-for-bit guarantee) every shard holds
    whole canonical reduction blocks; S divides over the scenario axis. The
    SORT2AGGREGATE sweeps (plain sums across shards) need only the first
    and the last."""
    check_batch_shapes(values, budgets, rules)
    check_shard_layout(values.shape[0], budgets.shape[0], spec,
                       require_block_alignment)


def global_event_offset(rank: int, local_n: int) -> int:
    """Global index of event rank ``rank``'s first row (``rank`` row-major
    over a spec's event axes, :meth:`SweepMeshSpec.event_coords`)."""
    return rank * local_n


def check_overlay(overlay: Optional[ScenarioOverlay], *, n_scenarios: int,
                  n_campaigns: int, resolve: str) -> None:
    """The :class:`~repro_torch.core.types.ScenarioOverlay` contract, with
    ``repro``'s texts: fields are (S, C); live windows come in pairs;
    stochastic fields need the family key; and per-event overlays (bid
    noise, participation jitter, time-varying windows) run on the
    ``"torch"`` back-end only, so a kernel back-end (``"fused"``, which
    ``"auto"`` picks on CUDA, ``"sweep_resolve"`` or
    :data:`ANY_C_BACKEND`) refuses them rather than ignore them. Static
    windows fold into the activation mask and run everywhere."""
    if overlay is None:
        return
    shape = (n_scenarios, n_campaigns)
    for name in ScenarioOverlay.FIELDS:
        arr = getattr(overlay, name)
        if arr is not None and tuple(arr.shape) != shape:
            raise ValueError(
                f"ScenarioOverlay.{name} must be (S, C)={shape}, got "
                f"{tuple(arr.shape)}")
    if (overlay.live_start is None) != (overlay.live_stop is None):
        raise ValueError(
            "ScenarioOverlay live windows need BOTH live_start and "
            "live_stop (half-open [start, stop) per scenario×campaign)")
    if overlay.time_varying and overlay.live_start is None:
        raise ValueError(
            "ScenarioOverlay.time_varying=True without live windows; "
            "time_varying only qualifies live_start/live_stop")
    if (overlay.bid_sigma is not None or overlay.part_prob is not None) \
            and overlay.key is None:
        raise ValueError(
            "stochastic overlay fields (bid_sigma / part_prob) need "
            "ScenarioOverlay.key — the family PRNG key their CRN streams "
            "derive from (repro_torch.core.crn)")
    if overlay.per_event and resolve != "torch":
        raise ValueError(
            "per-event scenario overlays (bid noise, participation jitter, "
            "time-varying live windows) run on the torch resolve path only; "
            "use resolve='torch' (or 'auto' off-CUDA, which lowers to the "
            "identical torch program). Static pause/boost overlays compose "
            "with every kernel back-end.")


def _overlay_noise(overlay: Optional[ScenarioOverlay], n_events: int,
                   n_campaigns: int, device):
    """The overlay's (N, C) CRN noise fields on ``device``, drawn ONCE over
    global event indices (scenario-independent: every lane shares them,
    chunks slice them)."""
    if overlay is None:
        return None, None
    gidx = torch.arange(n_events, dtype=torch.int32, device=device)
    z = u = None
    if overlay.bid_sigma is not None:
        z = crn.event_campaign_normals(
            crn.stream_key(overlay.key, "bid_noise"), gidx, n_campaigns)
    if overlay.part_prob is not None:
        u = crn.event_campaign_uniforms(
            crn.stream_key(overlay.key, "participation"), gidx, n_campaigns)
    return z, u


def _local_overlay(overlay: Optional[ScenarioOverlay]):
    """The overlay without its key: the per-lane form the round program
    takes (the noise is drawn already, only (S, C) fields remain, so a
    scenario chunk slices every field alike)."""
    if overlay is None:
        return None
    return dataclasses.replace(overlay, key=None)


# ---------------------------------------------------------------------------
# Per-lane logic, batched over lanes (repro's bit-for-bit contract)
# ---------------------------------------------------------------------------

def lane_predict(rates, b, s_hat, active, n_hat, *, n_events: int):
    """Predict, per lane, which campaign caps out next and where its block
    ends, from the (S, C) remaining-rate estimate. Returns ``(c_next (S,)
    int32, no_cap (S,) bool, n_next (S,) int32)``."""
    ttl = torch.where(active & (rates > 0), (b - s_hat) / rates,
                      float("inf"))
    ttl = torch.where(ttl < 0, 0.0, ttl)          # past budget -> retire
    c_next = torch.argmin(ttl, dim=-1, keepdim=True)
    ttl_next = ttl.gather(-1, c_next)[..., 0]
    no_cap = torch.isinf(ttl_next)
    # floor(ttl) clamped to N before the int cast (inf-safe)
    step = torch.clamp(torch.floor(ttl_next), max=float(n_events))
    n_next = torch.where(no_cap, n_events,
                         torch.clamp(n_hat + step.to(torch.int32),
                                     max=n_events))
    return c_next[..., 0].to(torch.int32), no_cap, n_next.to(torch.int32)


def lane_commit(blk, c_next, no_cap, n_next, s_hat, active, cap, rnd,
                retired, bnds, *, sentinel: int):
    """Apply the exact block spends, retire the predicted campaign, log the
    round — for every lane. Lanes past their last round (``rnd == C+1``)
    write their log entry into the last slot; the loop discards frozen
    lanes' updates."""
    lanes = torch.arange(s_hat.shape[0], device=s_hat.device)
    c = c_next.long()
    keep_cap = no_cap[:, None]
    s_hat = s_hat + blk
    cap_new = cap.clone()
    cap_new[lanes, c] = torch.clamp(n_next + 1, max=sentinel)
    cap = torch.where(keep_cap, cap, cap_new)
    act_new = active.clone()
    act_new[lanes, c] = False
    active = torch.where(keep_cap, active, act_new)
    retired = retired.clone()
    retired[lanes, rnd.long().clamp(max=retired.shape[1] - 1)] = \
        torch.where(no_cap, -1, c_next)
    bnds = bnds.clone()
    bnds[lanes, (rnd.long() + 1).clamp(max=bnds.shape[1] - 1)] = n_next
    return (s_hat, active, cap, n_next, rnd + 1, retired, bnds)


# ---------------------------------------------------------------------------
# The round body and the round loop
# ---------------------------------------------------------------------------

def _on(x, device):
    """``x`` on ``device``: itself where it is there already (no copy)."""
    return x if x is None or x.device == device else x.to(device)


def _make_round_body(plan: SweepPlan, resolve: str, *, values, rules,
                     budgets_f32, n_events: int, n_campaigns: int,
                     overlay: Optional[ScenarioOverlay] = None,
                     noise=(None, None), resume_offset: int = 0,
                     chunk_rows=None, psum=None):
    """The per-round map ``round_body(core, keep) -> core'`` for the
    ``"torch"``, ``"sweep_resolve"`` or :data:`ANY_C_BACKEND` (resolve-once)
    or ``"fused"`` back-end; with ``plan.chunks``, the two-pass shape
    (each pass a loop over the chunks) on every back-end. ``overlay`` holds
    these lanes' (S, C) intervention fields (key stripped), ``noise`` the
    (N, C) CRN draws ``(z, u)`` of every event.

    ``values`` are the rows of global events ``[resume_offset, n_events)``
    (a resumable fold's new rows; the whole log otherwise). A non-zero
    offset rules out the one-launch fused round, whose launch assumes its
    rows start the log: the fused back-end then takes two ``sweep_partials``
    passes over the rows at that offset, and the others place their
    partials there. ``chunk_rows()``, when given, yields the rows of every
    pass as ``(global offset, rows)`` pairs in order — a host-streamed
    log's chunks, or a sharded log's shards (or their chunks), each on its
    own device — and also rules out the one-launch round; by default the
    chunks are slices of ``values``, or ``values`` whole when the plan has
    no chunks. Each part's partials are computed on its rows' device and
    added on the lanes' device in order; ``psum`` then combines a pass's
    partials across processes (the multihost all-reduce)."""
    sentinel = never_capped(n_events)
    second = rules.kind == "second_price"
    block = seg_lib.reduce_block_size(n_events)
    b = budgets_f32
    home = b.device
    reserves = rules.reserve.to(torch.float32).expand(b.shape[0])
    chunks = plan.chunks
    psum = psum or (lambda t: t)
    one_launch = resolve == "fused" and chunks is None and \
        resume_offset == 0 and chunk_rows is None

    ol = overlay
    z_all, u_all = noise
    per_event = ol is not None and ol.per_event
    live_static = None
    if ol is not None and ol.live_start is not None and not per_event:
        # time_varying=False promises every window is empty or full: the
        # windows fold into the activation mask every back-end sees
        live_static = ol.live_stop > ol.live_start

    # the lanes' perturbed valuations do not change from round to round:
    # an unchunked one-device sweep draws them once ((S, N, C), one
    # bid_noise launch on CUDA); a chunked or sharded one perturbs each
    # part's rows every round, so its memory stays a part's
    noisy = None
    if per_event and ol.bid_sigma is not None and chunks is None \
            and chunk_rows is None:
        noisy = crn_ops.bid_noise(values, z_all, ol.bid_sigma)

    lane_state = {}

    def lanes_on(device):
        """The lanes' multipliers and reserves on ``device``, copied once."""
        if device not in lane_state:
            lane_state[device] = (_on(rules.multipliers, device),
                                  _on(reserves, device))
        return lane_state[device]

    def resolve_per_event(v, active, offset):
        """(S, n) winners/prices of the rows ``v`` (global events from
        ``offset``) under the per-event overlay, one lane at a time: the
        rows perturbed by the lane's bid noise, the lane's mask ANDed with
        its live windows on the global indices and with its participation
        draws, then the torch resolve."""
        n = v.shape[0]
        dev = v.device
        mult, res = lanes_on(dev)
        lo = offset - resume_offset
        gidx = offset + torch.arange(n, dtype=torch.int32, device=dev)
        z = None if z_all is None else _on(z_all[offset:offset + n], dev)
        u = None if u_all is None else _on(u_all[offset:offset + n], dev)
        out = []
        for s in range(active.shape[0]):
            vv = v
            if noisy is not None:
                vv = noisy[s][lo:lo + n]
            elif ol.bid_sigma is not None:
                vv = crn_ops.bid_noise(v, z, _on(ol.bid_sigma[s:s + 1],
                                                  dev))[0]
            m = active[s][None, :].expand(n, n_campaigns)
            if ol.live_start is not None:
                m = m & (gidx[:, None] >= _on(ol.live_start[s], dev)[None, :]) \
                    & (gidx[:, None] < _on(ol.live_stop[s], dev)[None, :])
            if ol.part_prob is not None:
                m = m & (u < _on(ol.part_prob[s], dev)[None, :])
            out.append(auction.resolve(vv, m, AuctionRule(
                multipliers=mult[s], reserve=res[s], kind=rules.kind)))
        return (torch.stack([w for w, _ in out]),
                torch.stack([p for _, p in out]))

    def resolve_lanes(v, active, offset):
        """(S, n) winners/prices of every lane over the rows ``v`` (global
        events from ``offset``; ``active`` on their device): one
        ``sweep_resolve`` or, for :data:`ANY_C_BACKEND`, one
        ``auction_resolve`` launch (and its chunk merge) for all lanes, or
        the torch path one lane at a time (the bids tensor is then (n, C),
        never (S, n, C)), under a per-event overlay when there is one."""
        if per_event:
            return resolve_per_event(v, active, offset)
        mult, res = lanes_on(v.device)
        if resolve == "sweep_resolve":
            winners, prices, _ = resolve_ops.sweep_resolve(
                v, mult, active, res, second_price=second)
            return winners, prices
        if resolve == ANY_C_BACKEND:
            return resolve_ops.resolve_lanes(v, mult, active, res,
                                             second_price=second)
        out = [auction.resolve(v, active[s], AuctionRule(
            multipliers=mult[s], reserve=res[s], kind=rules.kind))
            for s in range(active.shape[0])]
        return (torch.stack([w for w, _ in out]),
                torch.stack([p for _, p in out]))

    def weighted_partials(winners, prices, lo, hi, offset):
        """(S, G, C) canonical partials of the events in ``[lo, hi)``, the
        rows global events from ``offset``, computed on the rows' device
        and returned on the lanes'."""
        dev = winners.device
        return _on(seg_lib.window_partials(
            winners, prices, n_campaigns, _on(lo, dev), _on(hi, dev),
            block_size=block, index_offset=offset), home)

    def device_rows():
        if chunks is None:
            yield resume_offset, values
            return
        epc = chunks.events_per_chunk
        for offset in range(resume_offset, n_events, epc):
            yield offset, values[offset - resume_offset:
                                 offset - resume_offset + epc]

    rows_of = device_rows if chunk_rows is None else chunk_rows

    def fused_partials(v, active, keep, lo, hi, offset):
        dev = v.device
        mult, res = lanes_on(dev)
        return _on(resolve_ops.sweep_partials(
            v, mult, _on(active, dev), res, _on(lo, dev), _on(hi, dev),
            _on(keep, dev), offset, n_events_global=n_events,
            reduce_blocks=seg_lib.REDUCE_BLOCKS, second_price=second,
            skip_retired=plan.skip_retired), home)

    def window_partials(active, keep, lo, hi):
        """One pass of the two-pass shape: (S, G, C) partials of each
        lane's window ``[lo, hi)``, a loop over the parts in order adding
        each part's partials (``repro``'s chunk scan and mesh psum; one
        pass over ``values`` when the plan has no chunks and no parts).
        Where every part starts on a canonical block, each block is one
        part's and the sum adds exact zeros: the bits are the unchunked
        sweep's. A resumable fold whose offset is not on a block lets a
        block straddle two chunks; its sum is then regrouped, bitwise
        ``repro``'s chunked fold but not the unchunked one."""
        acc = None
        for offset, v in rows_of():
            if resolve == "fused":
                parts = fused_partials(v, active, keep, lo, hi, offset)
            else:
                winners, prices = resolve_lanes(v, _on(active, v.device),
                                                offset)
                parts = weighted_partials(winners, prices, lo, hi, offset)
            acc = parts if acc is None else acc + parts
        return psum(acc)

    two_pass = chunks is not None or resolve == "fused"

    def round_body(core, keep):
        s_hat, active, cap, n_hat, rnd, retired, bnds = core
        # static live windows AND into the mask every resolve sees;
        # lane_predict keeps the carried `active` (a masked-off campaign
        # never wins, so its rate is 0 and its ttl inf either way)
        act = active if live_static is None else active & live_static
        if one_launch:
            _, block_parts, c_next, no_cap, n_next = resolve_ops.round_fused(
                values, rules.multipliers, act, reserves, b, s_hat,
                n_hat, keep, reduce_blocks=seg_lib.REDUCE_BLOCKS,
                second_price=second, skip_retired=plan.skip_retired)
        else:
            hi_all = torch.full_like(n_hat, n_events)
            if two_pass:
                rate_parts = window_partials(act, keep, n_hat, hi_all)
            else:
                # one resolve of every part a round, read by both passes
                resolved = [(offset, *resolve_lanes(v, _on(act, v.device),
                                                    offset))
                            for offset, v in rows_of()]

                def resolved_partials(lo, hi):
                    acc = None
                    for offset, winners, prices in resolved:
                        parts = weighted_partials(winners, prices, lo, hi,
                                                  offset)
                        acc = parts if acc is None else acc + parts
                    return psum(acc)

                rate_parts = resolved_partials(n_hat, hi_all)
            denom = torch.clamp(n_events - n_hat, min=1).to(torch.float32)
            rates = seg_lib.fold_blocks(rate_parts) / denom[:, None]
            c_next, no_cap, n_next = lane_predict(rates, b, s_hat, active,
                                                  n_hat, n_events=n_events)
            if two_pass:
                block_parts = window_partials(act, keep, n_hat, n_next)
            else:
                block_parts = resolved_partials(n_hat, n_next)
        blk = seg_lib.fold_blocks(block_parts)
        return lane_commit(blk, c_next, no_cap, n_next, s_hat, active, cap,
                           rnd, retired, bnds, sentinel=sentinel)

    return round_body


def _alive(core, *, n_events: int, n_campaigns: int) -> torch.Tensor:
    _, active, _, n_hat, rnd, _, _ = core
    return (rnd < n_campaigns + 1) & (n_hat < n_events) & active.any(-1)


def _run_loop(round_body, *, n_scenarios: int, n_events: int,
              n_campaigns: int, device, init_core=None):
    """Run rounds until every lane has retired its last cap-out (at most
    C+1), freezing finished lanes with ``torch.where``. One host sync per
    round, for the alive check. Returns the carried core state.
    ``init_core`` replaces the fresh initial state (a resumable fold's
    carried state, :func:`_carried_core`)."""
    s, c = n_scenarios, n_campaigns
    i32 = dict(dtype=torch.int32, device=device)
    core = init_core if init_core is not None else (
        torch.zeros((s, c), dtype=torch.float32, device=device),   # s_hat
        torch.ones((s, c), dtype=torch.bool, device=device),       # active
        torch.full((s, c), never_capped(n_events), **i32),         # cap
        torch.zeros(s, **i32),                                     # n_hat
        torch.zeros(s, **i32),                                     # rnd
        torch.full((s, c + 1), -1, **i32),                         # retired
        torch.zeros((s, c + 2), **i32),                            # bnds
    )
    keep = _alive(core, n_events=n_events, n_campaigns=n_campaigns)
    while bool(keep.any()):
        new = round_body(core, keep)
        core = tuple(
            torch.where(keep.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)
            for n, o in zip(new, core))
        keep = _alive(core, n_events=n_events, n_campaigns=n_campaigns)
    return core


def _unpack(core):
    s_hat, _, cap, n_hat, rnd, retired, bnds = core
    return s_hat, cap, retired, bnds, rnd, n_hat


def _run_lanes(plan: SweepPlan, resolve: str, *, values, rules,
               budgets_f32, n_events: int, n_campaigns: int,
               overlay: Optional[ScenarioOverlay] = None,
               noise=(None, None), chunk_rows=None, psum=None,
               device=None):
    """Run the lanes through the round program, one scenario chunk after
    another when the plan asks for them (``repro``'s ``_run_lanes``): each
    chunk builds its own round body and loop over its slice of budgets,
    multipliers, reserves and overlay fields (the (N, C) noise is every
    chunk's), and the chunks' results are concatenated. Lanes never read
    each other, so the bits are the unchunked sweep's. ``chunk_rows`` and
    ``psum`` go to :func:`_make_round_body` (a sharded or multihost
    sweep's parts); ``device`` is where the rows are computed on
    (``values``' by default)."""
    s_all = budgets_f32.shape[0]
    reserves = rules.reserve.to(torch.float32).expand(s_all)
    device = values.device if device is None else device

    def run(lanes):
        rules_c = AuctionRule(multipliers=rules.multipliers[lanes],
                              reserve=reserves[lanes], kind=rules.kind)
        ol_c = None if overlay is None else \
            overlay.map_fields(lambda x: x[lanes])
        round_body = _make_round_body(
            plan, resolve, values=values, rules=rules_c,
            budgets_f32=budgets_f32[lanes], n_events=n_events,
            n_campaigns=n_campaigns, overlay=ol_c, noise=noise,
            chunk_rows=chunk_rows, psum=psum)
        return _run_loop(round_body, n_scenarios=budgets_f32[lanes].shape[0],
                         n_events=n_events, n_campaigns=n_campaigns,
                         device=budgets_f32.device)

    spc = planned_scenario_chunk(plan, s_all, n_campaigns, resolve,
                                 device=device)
    if spc is None or spc == s_all:
        return run(slice(0, s_all))
    outs = [run(slice(s0, s0 + spc)) for s0 in range(0, s_all, spc)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _sweep_batched(values, budgets, rules, plan: SweepPlan,
                   overlay: Optional[ScenarioOverlay] = None):
    """The scenario-batched Algorithm-2 loop on one device."""
    check_batch_shapes(values, budgets, rules)
    n_events, n_campaigns = values.shape
    n_scenarios = budgets.shape[0]
    resolve = pick_resolve(plan.resolve, values.device, n_campaigns)
    check_overlay(overlay, n_scenarios=n_scenarios, n_campaigns=n_campaigns,
                  resolve=resolve)
    check_chunks(plan.chunks, n_events=n_events, local_n=n_events)
    check_scenario_chunks(plan.scenario_chunks, n_scenarios=n_scenarios,
                          local_s=n_scenarios)
    if overlay is not None:
        overlay = overlay.map_fields(lambda x: x.to(values.device))
    noise = _overlay_noise(overlay, n_events, n_campaigns, values.device)
    core = _run_lanes(plan, resolve, values=values, rules=rules,
                      budgets_f32=budgets.to(torch.float32),
                      n_events=n_events, n_campaigns=n_campaigns,
                      overlay=_local_overlay(overlay), noise=noise)
    return _unpack(core)


def _part_rows(parts, chunks: Optional[ChunkSpec]):
    """The ``chunk_rows`` of a sharded pass: every part's ``(global offset,
    rows)`` in order, each part scanned a chunk at a time when the plan has
    chunks (chunks × sharding)."""
    def rows():
        for offset, v in parts:
            if chunks is None:
                yield offset, v
                continue
            epc = chunks.events_per_chunk
            for k in range(0, v.shape[0], epc):
                yield offset + k, v[k:k + epc]
    return rows


def _mesh_resolve(plan: SweepPlan, spec: SweepMeshSpec,
                  n_campaigns: int) -> str:
    """:func:`pick_resolve` for the mesh's devices (one kind of device a
    mesh)."""
    kinds = {d.type for d in spec.mesh.devices}
    if len(kinds) != 1:
        raise ValueError(f"a sweep mesh holds one kind of device, got "
                         f"{sorted(kinds)}")
    return pick_resolve(plan.resolve, spec.mesh.devices[0], n_campaigns)


def shard_log(values, spec: SweepMeshSpec, group: int = 0):
    """``(global offset, rows)`` of every event rank of ``spec``, in rank
    order, on the devices of scenario group ``group``: slices of a tensor
    ``values`` (views where the device is its own), or a
    :class:`~repro_torch.launch.mesh.ShardedLog`'s shards when it is laid
    out over the same event ranks (else it is put together and split
    again)."""
    d_ev = spec.event_device_count
    if isinstance(values, ShardedLog):
        if len(values.shards) == d_ev:
            return [(off, _on(v, spec.shard_device(r, group)))
                    for r, (off, v) in enumerate(zip(values.offsets,
                                                     values.shards))]
        values = values.full()
    local_n = values.shape[0] // d_ev
    return [(global_event_offset(r, local_n),
             _on(values[r * local_n:(r + 1) * local_n],
                 spec.shard_device(r, group)))
            for r in range(d_ev)]


def _sweep_sharded(values, budgets, rules, plan: SweepPlan,
                   overlay: Optional[ScenarioOverlay] = None):
    """The scenario-batched loop on a one-process mesh (``repro``'s
    ``_sweep_sharded``): events over the spec's event ranks, scenarios over
    its scenario axis, one round loop a scenario group, the outputs on the
    budgets' device in lane order."""
    spec = plan.mesh
    check_sharded_shapes(values, budgets, rules, spec)
    n_events, n_campaigns = values.shape
    n_scenarios = budgets.shape[0]
    resolve = _mesh_resolve(plan, spec, n_campaigns)
    local_n = n_events // spec.event_device_count
    check_overlay(overlay, n_scenarios=n_scenarios, n_campaigns=n_campaigns,
                  resolve=resolve)
    check_chunks(plan.chunks, n_events=n_events, local_n=local_n)
    d_sc = spec.scenario_device_count
    s_loc = n_scenarios // d_sc
    check_scenario_chunks(plan.scenario_chunks, n_scenarios=n_scenarios,
                          local_s=s_loc)
    home = budgets.device
    if overlay is not None:
        overlay = overlay.map_fields(lambda x: x.to(home))
    # the overlay's CRN noise is drawn ONCE on global indices; every part
    # reads its own rows of it
    noise = _overlay_noise(overlay, n_events, n_campaigns, home)
    overlay = _local_overlay(overlay)
    reserves = rules.reserve.to(torch.float32).expand(n_scenarios)
    outs = []
    for group in range(d_sc):
        lanes = slice(group * s_loc, (group + 1) * s_loc)
        rows = _part_rows(shard_log(values, spec, group), plan.chunks)
        outs.append(_run_lanes(
            plan, resolve, values=None,
            rules=AuctionRule(multipliers=rules.multipliers[lanes],
                              reserve=reserves[lanes], kind=rules.kind),
            budgets_f32=budgets[lanes].to(torch.float32), n_events=n_events,
            n_campaigns=n_campaigns,
            overlay=None if overlay is None else overlay.map_fields(
                lambda x: x[lanes]),
            noise=noise, chunk_rows=rows,
            device=spec.shard_device(0, group)))
    core = outs[0] if d_sc == 1 else tuple(torch.cat(parts)
                                           for parts in zip(*outs))
    return _unpack(core)


# the multihost sweep's all-reduces (one a pass) since the last reset
COLLECTIVES = {"all_reduce": 0}


def reset_collectives() -> None:
    COLLECTIVES["all_reduce"] = 0


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ``torch.distributed`` world, in place (NCCL,
    or gloo, which takes CUDA tensors too)."""
    COLLECTIVES["all_reduce"] += 1
    torch.distributed.all_reduce(t)
    return t


def _sweep_multihost(values_local, budgets, rules, plan: SweepPlan,
                     overlay: Optional[ScenarioOverlay] = None):
    """The sharded program over a ``torch.distributed`` world (``repro``'s
    ``_sweep_multihost``): ``values_local`` is this rank's contiguous rows
    of the global log (rank ``r`` holds events ``[r·local_n,
    (r+1)·local_n)``), budgets and rules are replicated; each pass's
    partials are summed over the world by one ``all_reduce``, so every rank
    runs the same rounds and returns the same (replicated) outputs, bit
    for bit the one-process sharded and batched sweeps. Under one process
    it is the sharded sweep of a one-shard mesh."""
    spec = plan.mesh
    if spec.scenario_axis is not None:
        raise ValueError(
            "placement='multihost' shards events over processes only; "
            "scenario-axis process meshes are not supported (shard "
            "scenarios within one process via placement='sharded').")
    if overlay is not None:
        raise ValueError(
            "overlays are not supported with placement='multihost' yet; "
            "run overlay families on placement='sharded' or 'batched'.")
    dist = torch.distributed
    multi = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if multi else 1
    rank = dist.get_rank() if multi else 0
    if spec.event_device_count != world:
        raise ValueError(
            f"the multihost mesh has {spec.event_device_count} event shards "
            f"but the torch.distributed world has {world} processes; build "
            "it with SweepMeshSpec.for_processes() after "
            "distributed_initialize")
    check_batch_shapes(values_local, budgets, rules)
    local_n, n_campaigns = values_local.shape
    n_events = local_n * world
    check_shard_layout(n_events, budgets.shape[0], spec)
    resolve = pick_resolve(plan.resolve, values_local.device, n_campaigns)
    check_chunks(plan.chunks, n_events=n_events, local_n=local_n)
    check_scenario_chunks(plan.scenario_chunks, n_scenarios=budgets.shape[0],
                          local_s=budgets.shape[0])
    offset = global_event_offset(rank, local_n)
    core = _run_lanes(
        dataclasses.replace(plan, placement="sharded"), resolve, values=None,
        rules=rules, budgets_f32=budgets.to(torch.float32),
        n_events=n_events, n_campaigns=n_campaigns,
        chunk_rows=_part_rows([(offset, values_local)], plan.chunks),
        psum=_all_reduce if world > 1 else None,
        device=values_local.device)
    return _unpack(core)


def _as_host_stream(values, plan: SweepPlan, *,
                    overlay: Optional[ScenarioOverlay] = None
                    ) -> Optional[HostStream]:
    """``values`` as a :class:`HostStream` when the sweep is host-streamed
    (a ``HostStream``, or ``chunks.source="host"``, which copies an
    in-memory log to host memory once), after :func:`check_host_stream`;
    None for a device-resident sweep."""
    if not (isinstance(values, HostStream) or (
            plan.chunks is not None and plan.chunks.source == "host")):
        return None
    check_host_stream(plan, overlay=overlay)
    return values if isinstance(values, HostStream) \
        else HostStream.from_array(values)


def execute_sweep(values, budgets, rules, plan: SweepPlan, *,
                  overlay: Optional[ScenarioOverlay] = None):
    """Run the Algorithm-2 sweep program described by ``plan``.

    ``placement="batched"`` takes budgets (S, C) and a stacked rule and
    returns ``(s_hat (S, C) float32, cap_times (S, C) int32, retired
    (S, C+1) int32, boundaries (S, C+2) int32, num_rounds (S,) int32,
    n_hat (S,) int32)``; ``placement="device"`` takes one scenario (budgets
    (C,), an unstacked rule) and returns the unbatched tuple.
    ``plan.chunks`` and ``plan.scenario_chunks`` give the same bits.

    ``overlay`` threads a :class:`~repro_torch.core.types.ScenarioOverlay`
    through the round body (:func:`check_overlay`); ``None`` runs the
    overlay-free program. For ``placement="device"`` its fields are (C,)
    rows, like the unbatched budgets and rule.

    A :class:`HostStream` ``values`` (or ``chunks.source="host"``, which
    copies an in-memory ``values`` to host memory once) runs the
    host-streamed sweep on the budgets' device (:func:`_sweep_hoststream`),
    bit for bit the device-resident sweep on aligned chunk sizes.

    ``placement="sharded"`` takes the whole log (a tensor, or a
    :class:`~repro_torch.launch.mesh.ShardedLog`) and runs it on
    ``plan.mesh`` (:func:`_sweep_sharded`); ``placement="multihost"``
    takes THIS RANK's event shard as ``values`` and returns the outputs
    on every rank (:func:`_sweep_multihost`). Both are bit for bit the
    batched sweep on aligned shapes.

    ``plan.block_t="auto"`` / ``plan.tuned=True`` resolve here, before
    anything runs (:func:`resolve_auto_plan`), to a plan whose outputs are
    the default plan's bit for bit.
    """
    if needs_tuning(plan):
        n_ev, n_c = tuple(values.shape)
        plan = resolve_auto_plan(
            plan, n_events=int(n_ev), n_campaigns=int(n_c),
            n_scenarios=int(budgets.shape[0]) if budgets.ndim == 2 else 1,
            device=values.device if isinstance(values, torch.Tensor)
            else budgets.device)
    stream = _as_host_stream(values, plan, overlay=overlay)
    if plan.placement == "multihost":
        return _sweep_multihost(values, budgets, rules, plan, overlay)
    if plan.placement == "sharded":
        return _sweep_sharded(values, budgets, rules, plan, overlay)
    unbatched = plan.placement == "device"
    if unbatched:
        budgets = budgets[None, :]
        rules = AuctionRule(multipliers=rules.multipliers[None, :],
                            reserve=rules.reserve.reshape(1), kind=rules.kind)
        if overlay is not None:
            overlay = overlay.map_fields(lambda x: x[None])
        plan = dataclasses.replace(plan, placement="batched")
    if stream is not None:
        out = _unpack(_sweep_hoststream(stream, budgets, rules, plan))
    else:
        out = _sweep_batched(values, budgets, rules, plan, overlay)
    return tuple(x[0] for x in out) if unbatched else out


# ---------------------------------------------------------------------------
# The host-streamed log: two device buffers and a copy stream
# ---------------------------------------------------------------------------

# what the host pipeline copied to the card since the last reset: chunk
# copies, their bytes, and the copies of chunks put together in a staging
# buffer (a window across two slabs)
H2D = {"copies": 0, "bytes": 0, "staged": 0}


def reset_h2d() -> None:
    for name in H2D:
        H2D[name] = 0


class _HostPipeline:
    """Streams a :class:`HostStream`'s rows ``[0, n)``, which are global
    events ``[offset, offset + n)``, to ``device`` in chunks of ``epc``.

    On CUDA it holds two chunk buffers on the card and, for chunks that
    straddle two slabs, two pinned staging buffers. With ``prefetch`` the
    copy of chunk k+1 runs on a copy stream while chunk k is reduced on the
    current stream: the compute waits for the copy into its buffer (an
    event), and the copy into a buffer waits for the compute that last read
    it (another event); the host waits for a staging buffer's last copy
    before it writes the buffer again. Without ``prefetch`` each chunk is
    copied and reduced on the current stream, and the host waits for both.
    On the CPU the chunks are the slabs' rows themselves."""

    def __init__(self, stream: HostStream, epc: int, offset: int, device,
                 prefetch: bool):
        self.stream, self.epc, self.offset = stream, epc, offset
        self.device, self.prefetch = torch.device(device), prefetch
        self.n_chunks = stream.n_events // epc
        if self.device.type != "cuda":
            return
        shape = (epc, stream.n_campaigns)
        self.bufs = [torch.empty(shape, dtype=torch.float32,
                                 device=self.device) for _ in range(2)]
        self.staging = [None, None]
        self.copy_stream = torch.cuda.Stream(self.device)
        self.copied = [torch.cuda.Event() for _ in range(2)]
        self.read = [torch.cuda.Event() for _ in range(2)]

    def _host_rows(self, k: int) -> torch.Tensor:
        i, start, stop = k % 2, k * self.epc, (k + 1) * self.epc
        if not self.stream.straddles(start, stop):
            rows = self.stream.chunk(start, stop)
            if rows.is_pinned():
                return rows
        # put together in a pinned staging buffer (from unpinned memory the
        # copy would be synchronous), once the buffer's last copy has left
        if self.staging[i] is None:
            self.staging[i] = torch.empty(tuple(self.bufs[i].shape),
                                          dtype=torch.float32,
                                          pin_memory=True)
        self.copied[i].synchronize()
        H2D["staged"] += 1
        return self.stream.chunk(start, stop, out=self.staging[i])

    def _copy(self, k: int) -> None:
        i = k % 2
        rows = self._host_rows(k)
        H2D["copies"] += 1
        H2D["bytes"] += rows.numel() * rows.element_size()
        if not self.prefetch:
            self.bufs[i].copy_(rows)
            return
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self.read[i])
            self.bufs[i].copy_(rows, non_blocking=True)
            self.copied[i].record(self.copy_stream)

    def rows(self):
        """Yield ``(global offset, rows on the device)`` for every chunk, in
        order; the caller's work on a chunk is enqueued before the next one
        is asked for."""
        epc, n = self.epc, self.n_chunks
        if self.device.type != "cuda":
            for k in range(n):
                yield (self.offset + k * epc,
                       self.stream.chunk(k * epc, (k + 1) * epc))
            return
        compute = torch.cuda.current_stream(self.device)
        if self.prefetch:
            self._copy(0)
        for k in range(n):
            i = k % 2
            if not self.prefetch:
                self._copy(k)
            elif k + 1 < n:
                self._copy(k + 1)
            if self.prefetch:
                compute.wait_event(self.copied[i])
            yield self.offset + k * epc, self.bufs[i]
            if self.prefetch:
                self.read[i].record(compute)
            else:
                compute.synchronize()


def _sweep_hoststream(stream: HostStream, budgets, rules, plan: SweepPlan,
                      *, carry: Optional["SweepCarry"] = None):
    """The host-streamed Algorithm-2 loop on the budgets' device (``repro``'s
    ``_sweep_hoststream``): the chunked two-pass round program, its chunk
    loop fed by :class:`_HostPipeline`, so the bits are the device-resident
    chunked sweep's on aligned sizes. ``carry`` seeds a resumable fold at
    global offset ``carry.n_events_seen``, as :func:`_resume_batched` does.
    Returns the core state."""
    check_batch_shapes(stream, budgets, rules)
    n_new, n_campaigns = stream.shape
    device = budgets.device
    resolve = pick_resolve(plan.resolve, device, n_campaigns)
    n_seen = 0 if carry is None else carry.n_events_seen
    n_events = n_seen + n_new
    check_chunks(plan.chunks, n_events=n_events, local_n=n_new)
    pipeline = _HostPipeline(stream, plan.chunks.events_per_chunk, n_seen,
                             device, plan.chunks.prefetch)
    round_body = _make_round_body(
        plan, resolve, values=None, rules=rules,
        budgets_f32=budgets.to(torch.float32), n_events=n_events,
        n_campaigns=n_campaigns, resume_offset=n_seen,
        chunk_rows=pipeline.rows)
    return _run_loop(round_body, n_scenarios=budgets.shape[0],
                     n_events=n_events, n_campaigns=n_campaigns,
                     device=device,
                     init_core=None if carry is None
                     else _carried_core(carry, n_events, device))


# ---------------------------------------------------------------------------
# Resumable execution: fold new event slabs into carried burnout state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepCarry:
    """The per-scenario burnout state carried between resumable folds
    (``repro``'s ``SweepCarry``): ``s_hat`` (S, C) float32 spend so far,
    ``active`` (S, C) bool not-yet-capped campaigns, ``cap_times`` (S, C)
    int32 global cap indices (``never_capped(n_events_seen)`` for campaigns
    not capped), ``n_hat`` (S,) int32 each lane's frontier, and
    ``n_events_seen``, the events folded in so far (the next fold's global
    offset).

    A fold's predictions see only the events folded so far, so the carry is
    the causal (streaming) estimate of the growing log: bitwise the
    one-shot sweep when the whole log arrives in one fold."""

    s_hat: torch.Tensor
    active: torch.Tensor
    cap_times: torch.Tensor
    n_hat: torch.Tensor
    n_events_seen: int

    @property
    def num_scenarios(self) -> int:
        return self.s_hat.shape[0]

    @property
    def num_campaigns(self) -> int:
        return self.s_hat.shape[1]

    def to(self, device) -> "SweepCarry":
        """The same carry on ``device``."""
        return dataclasses.replace(
            self, s_hat=self.s_hat.to(device), active=self.active.to(device),
            cap_times=self.cap_times.to(device), n_hat=self.n_hat.to(device))


def initial_carry(n_scenarios: int, n_campaigns: int, *,
                  device: DeviceLike = None) -> SweepCarry:
    """The empty log's carry on ``device`` (the card by default): nothing
    spent, every campaign active, every frontier at 0."""
    dev = pick_device(device)
    shape = (n_scenarios, n_campaigns)
    return SweepCarry(
        s_hat=torch.zeros(shape, dtype=torch.float32, device=dev),
        active=torch.ones(shape, dtype=torch.bool, device=dev),
        cap_times=torch.full(shape, never_capped(0), dtype=torch.int32,
                             device=dev),
        n_hat=torch.zeros(n_scenarios, dtype=torch.int32, device=dev),
        n_events_seen=0)


def _carried_core(carry: SweepCarry, n_events: int, device):
    """The round loop's initial state of a fold over a log that will hold
    ``n_events``: the carried burnout state, not-yet-capped campaigns moved
    to the grown log's sentinel, and a fresh round log (every fold has its
    C+1 rounds; active lanes leave a fold with ``n_hat`` at the events
    seen)."""
    carry = carry.to(device)
    s, c = carry.s_hat.shape
    active = carry.active.to(torch.bool)
    n_hat = carry.n_hat.to(torch.int32)
    bnds = torch.zeros((s, c + 2), dtype=torch.int32, device=device)
    bnds[:, 0] = n_hat
    return (carry.s_hat.to(torch.float32), active,
            torch.where(active, never_capped(n_events),
                        carry.cap_times.to(torch.int32)),
            n_hat,
            torch.zeros(s, dtype=torch.int32, device=device),
            torch.full((s, c + 1), -1, dtype=torch.int32, device=device),
            bnds)


def _resume_batched(values_new, budgets, rules, plan: SweepPlan,
                    carry: SweepCarry):
    """One resumable fold on the values' device: the batched round program
    over the new rows only, from the carried state, the rows placed on the
    global grid at ``carry.n_events_seen``."""
    n_new, n_campaigns = values_new.shape
    n_seen = carry.n_events_seen
    n_total = n_seen + n_new
    device = values_new.device
    resolve = pick_resolve(plan.resolve, device, n_campaigns)
    check_chunks(plan.chunks, n_events=n_total, local_n=n_new)
    round_body = _make_round_body(
        plan, resolve, values=values_new, rules=rules,
        budgets_f32=budgets.to(torch.float32), n_events=n_total,
        n_campaigns=n_campaigns, resume_offset=n_seen)
    return _run_loop(round_body, n_scenarios=budgets.shape[0],
                     n_events=n_total, n_campaigns=n_campaigns,
                     device=device,
                     init_core=_carried_core(carry, n_total, device))


def execute_sweep_resumable(values_new, budgets, rules, plan: SweepPlan, *,
                            carry: Optional[SweepCarry] = None):
    """Fold a slab of NEW event rows into carried per-scenario burnout state.

    Returns ``(outputs, new_carry)``: ``outputs`` is :func:`execute_sweep`'s
    batched 6-tuple for the updated state (``s_hat`` and ``cap_times``
    cumulative over every fold; ``retired``, ``boundaries`` and
    ``num_rounds`` this fold's rounds only), ``new_carry`` the
    :class:`SweepCarry` to pass back with the next slab. ``carry=None``
    starts from the empty log, so one fold over the whole log is bitwise
    :func:`execute_sweep`; each later fold works on the new rows only.
    ``placement="batched"`` only, any resolve back-end, event ``chunks=``
    within a slab, a :class:`HostStream` slab or ``chunks.source="host"``
    (folded without the new rows ever on the card at once); no scenario
    chunks. ``repro``'s texts for every error. A tuned plan runs at the
    defaults (the tuner models whole sweeps, not fold windows)."""
    plan = _untuned(plan)
    if plan.placement != "batched":
        raise ValueError(
            "execute_sweep_resumable runs placement='batched' only (the "
            f"streaming fold is a single-device program), got "
            f"{plan.placement!r}; use the exact replay path "
            "(execute_sweep) for sharded placements.")
    if plan.scenario_chunks is not None:
        raise ValueError(
            "scenario_chunks= is not supported by execute_sweep_resumable; "
            "fold scenario groups separately instead.")
    stream = _as_host_stream(values_new, plan)
    if stream is not None:
        values_new = stream
    check_batch_shapes(values_new, budgets, rules)
    n_new, n_campaigns = values_new.shape
    if n_new < 1:
        raise ValueError("resumable fold needs at least one new event row")
    n_scenarios = budgets.shape[0]
    if carry is None:
        carry = initial_carry(n_scenarios, n_campaigns,
                              device=budgets.device)
    if tuple(carry.s_hat.shape) != (n_scenarios, n_campaigns):
        raise ValueError(
            f"carry/batch mismatch: carry holds "
            f"{tuple(carry.s_hat.shape)} lanes but the fold got "
            f"(S, C)=({n_scenarios}, {n_campaigns})")
    if stream is not None:
        core = _sweep_hoststream(stream, budgets, rules, plan, carry=carry)
    else:
        core = _resume_batched(values_new, budgets, rules, plan, carry)
    s_hat, active, cap, n_hat, _, _, _ = core
    new_carry = SweepCarry(s_hat=s_hat, active=active, cap_times=cap,
                           n_hat=n_hat,
                           n_events_seen=carry.n_events_seen + n_new)
    return _unpack(core), new_carry


# ---------------------------------------------------------------------------
# The SORT2AGGREGATE sweep
# ---------------------------------------------------------------------------

def check_s2a_options(plan: SweepPlan, record_events: bool = False) -> None:
    """Validate the SORT2AGGREGATE sweep's plan (callable up front, so an
    engine can fail fast before paying for a warm start), with ``repro``'s
    texts."""
    if plan.placement == "multihost":
        raise ValueError(
            "placement='multihost' runs method='parallel' sweeps only; the "
            "sort2aggregate estimator scales out via placement='sharded' "
            "within one process.")
    if plan.chunks is not None:
        if plan.placement == "sharded":
            raise ValueError(
                "chunks= does not compose with the sharded sort2aggregate "
                "sweep (its first-crossing prefix is an all_gather'd "
                "cross-shard scan); use driver='batched' for chunked "
                "replays, or drop chunks=.")
        if plan.chunks.source == "host":
            raise ValueError(
                "host-streamed chunks apply to method='parallel' sweeps "
                "only; the chunked sort2aggregate replay scans a "
                "device-resident log (ChunkSpec(source='device')).")
        if record_events:
            raise ValueError(
                "record_events is not supported with chunks= on the "
                "sort2aggregate sweep: per-event winners/prices of the "
                "whole log are the O(N·C) residency chunking avoids. Drop "
                "record_events (spends/cap times stream fine) or drop "
                "chunks=.")
    if plan.scenario_chunks is not None:
        raise ValueError(
            "scenario_chunks= (scenario-chunked execution) currently "
            "applies to method='parallel' sweeps only; drop "
            "scenario_chunks= for the sort2aggregate sweep.")
    if plan.placement == "sharded" and record_events:
        raise ValueError(
            "record_events is not supported with driver='sharded': "
            "per-event winners/prices are an (S, N) gather off the "
            "mesh. Use driver='batched', or replay the scenarios of "
            "interest via sharded_aggregate.")


def execute_s2a_sweep(values, budgets, rules, plan: SweepPlan, *,
                      cap_times_init=None, refine_iters: int = 8,
                      record_events: bool = False,
                      crossing_block: int = 4096):
    """Run the SORT2AGGREGATE scenario sweep: every lane refined from its
    warm start (``cap_times_init`` (S, C) or (C,); all-active when None)
    for ``refine_iters`` fixed-point iterations, then aggregated. Both
    placements run the lanes batched: each pass resolves every lane (one
    ``segment_resolve`` launch on CUDA) and finds every lane's crossings
    in one call. With ``plan.chunks`` every pass is a loop over the chunks
    (:func:`repro_torch.core.sort2aggregate.refine_fixed_chunked`).
    ``placement="sharded"`` runs every pass on ``plan.mesh``
    (:func:`repro_torch.core.sharded.sweep_sort2aggregate_sharded`, which
    takes no ``crossing_block``: each shard is one crossing block, as in
    ``repro``). A tuned plan runs at the defaults (the tuner models the
    parallel sweep only). Returns ``(SimResult (S, ...), consistency_gaps
    (S,) float32, refine_iters_used (S,) int32)``."""
    plan = _untuned(plan)
    check_s2a_options(plan, record_events)
    if plan.placement == "sharded":
        from repro_torch.core.sharded import sweep_sort2aggregate_sharded
        return sweep_sort2aggregate_sharded(
            values, budgets, rules, plan.mesh,
            cap_times_init=cap_times_init, refine_iters=refine_iters)
    check_batch_shapes(values, budgets, rules)
    n_events, n_campaigns = values.shape
    if cap_times_init is None:
        cap_times_init = torch.full((n_campaigns,), never_capped(n_events),
                                    dtype=torch.int32)
    caps0 = torch.as_tensor(cap_times_init).to(values.device, torch.int32)
    caps0 = caps0.expand(budgets.shape[0], n_campaigns).contiguous()
    if plan.chunks is not None:
        return refine_fixed_chunked(
            values, budgets, rules, caps0,
            chunk_events=plan.chunks.events_per_chunk,
            refine_iters=refine_iters, crossing_block=crossing_block)
    return refine_fixed_lanes(values, budgets, rules, caps0,
                              refine_iters=refine_iters,
                              record_events=record_events,
                              crossing_block=crossing_block)
