"""The always-on counterfactual service: the sweep executor behind a
growing event log (port of ``repro.serve.counterfactual``).

Below this layer every call is one-shot: hand :func:`execute_sweep` a log
and a grid, get answers. The paper's setting, an ad platform with campaign
budgets, asks what-if questions while the day's log keeps growing, so
:class:`CounterfactualService` keeps the state a one-shot call throws away:

* **appends** — :meth:`~CounterfactualService.append` admits slabs of
  whole chunks of ``events_per_chunk`` (else the executor's "ragged chunk"
  text, :func:`~repro_torch.core.executor.check_append_alignment`), bumps
  the monotone ``log_version`` and folds the slab into every registered
  scenario's carried burnout state
  (:func:`~repro_torch.core.executor.execute_sweep_resumable`): work on
  the new rows only;
* **admission batches** — :meth:`~CounterfactualService.ask` queues a
  request and returns a :class:`Ticket`; :meth:`~CounterfactualService.flush`
  answers the queue with one :func:`execute_sweep` a pricing kind, the
  distinct designs as lanes, padded to whole scenario chunks with repeats
  of lane 0, routed back in admission order;
* **a cache** — answers are keyed on ``(log_version, fingerprint)``
  (:func:`~repro_torch.scenarios.family.design_fingerprint`, the exact
  design bytes), so overlapping grids and repeated callers run once; an
  append drops the cache; :attr:`~CounterfactualService.stats` counts hits
  and misses;
* **a host store and checkpoints** — ``store="host"`` keeps the log in
  pinned host memory: replays stream it through the executor's copy
  pipeline (:class:`~repro_torch.core.executor.HostStream`), folds stream
  the new slab, and the log is never whole on the card;
  :meth:`~CounterfactualService.save` / :meth:`~CounterfactualService.load`
  checkpoint the service in ``repro``'s layout
  (:mod:`repro_torch.checkpoint`), so either package restores the other's.

Two answers, kept apart as in ``repro``: the **exact path** (``ask``,
``sweep``) replays the whole stored log, bitwise a one-shot
``engine.sweep`` of it; the **streaming path** (``register``,
``streaming``) is the causal estimate whose rounds saw only the events
there at fold time, bitwise the exact path when the log arrived in one
append.

Answers are tensors on the service's device (the card unless ``device``
says otherwise).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.core import segments as seg_lib
from repro_torch.core import sweep as sweep_lib
from repro_torch.core.counterfactual import (CounterfactualEngine,
                                             ScenarioGrid, SweepResult)
from repro_torch.core.executor import (DEFAULT_BLOCK_T, ChunkSpec,
                                       HostStream, SweepCarry, SweepPlan,
                                       host_slab, as_chunk_spec,
                                       as_scenario_chunk_spec,
                                       check_append_alignment, execute_sweep,
                                       execute_sweep_resumable,
                                       initial_carry)
from repro_torch.core.types import AuctionRule, ScenarioOverlay, SimResult
from repro_torch.device import DeviceLike, pick_device
from repro_torch.scenarios.family import (CompiledFamily, design_fingerprint,
                                          family_fingerprints,
                                          grid_fingerprints)


@dataclasses.dataclass(frozen=True)
class ServiceAnswer:
    """One scenario's exact answer, pinned to the log version it replayed."""

    final_spend: torch.Tensor    # (C,)
    cap_times: torch.Tensor      # (C,)
    log_version: int


@dataclasses.dataclass
class Ticket:
    """The handle of one admitted :meth:`CounterfactualService.ask`.
    ``result()`` flushes the service's queue if the ticket is still
    pending; tickets admitted together are answered by one batched sweep."""

    seq: int
    fingerprint: str
    label: str
    _service: "CounterfactualService"
    _answer: Optional[ServiceAnswer] = None

    @property
    def done(self) -> bool:
        return self._answer is not None

    def result(self) -> ServiceAnswer:
        if self._answer is None:
            self._service.flush()
        return self._answer


@dataclasses.dataclass
class _StreamGroup:
    """The registered streaming scenarios of one pricing kind, folded
    together (lanes never read each other, so membership changes no
    lane's bits)."""

    labels: List[str]
    rules: AuctionRule           # stacked (S, C)
    budgets: torch.Tensor        # (S, C)
    carry: SweepCarry


class CounterfactualService:
    """A long-lived counterfactual answerer over a growing event log.

    ``budgets`` (C,) and ``base_rule`` are the base design of :meth:`ask`
    and :meth:`register`; ``events_per_chunk`` is the append granularity;
    ``max_batch`` bounds the lanes one flush runs at once (more run
    scenario-chunked); ``placement``, ``resolve``, ``chunks`` and
    ``scenario_chunks`` build the :class:`SweepPlan` of every exact replay,
    and every plan answers with the same bits.

    ``store="host"`` keeps the slabs in pinned host memory: exact replays
    stream them (``placement="batched"``, no scenario chunks, overlays
    refused by the executor), with chunk sizes realigned to the canonical
    grid at each log size (:meth:`_host_chunks`); ``events_per_chunk``
    must then be a multiple of ``REDUCE_BLOCKS``.

    ``placement="sharded"`` with ``mesh=`` (a
    :class:`repro_torch.launch.mesh.SweepMeshSpec`) runs every exact replay
    on the mesh (the device store's log split over its event ranks, lane
    batches padded to a multiple of its scenario groups), with the batched
    service's bits; the streaming folds stay one-device programs.
    ``tuned=True`` leaves the replay plan's free knobs to the tuner
    (:mod:`repro_torch.tune`) at each replay (the cache, else the cost
    model); stated ``chunks``/``scenario_chunks`` stay pinned, so append
    alignment and lane padding do not move, and every plan answers with
    the same bits. :meth:`tune` measures and pins a winner."""

    def __init__(self, budgets, base_rule: Optional[AuctionRule] = None, *,
                 events=None, events_per_chunk: int = 256,
                 max_batch: int = 32, placement: str = "batched",
                 resolve: str = "auto", mesh=None, chunks=None,
                 scenario_chunks=None, store: str = "device",
                 tuned: bool = False, device: DeviceLike = None):
        self.device = pick_device(device)
        self.base_budgets = torch.as_tensor(budgets).to(self.device,
                                                        torch.float32)
        if self.base_budgets.ndim != 1:
            raise ValueError(
                f"service budgets are the (C,) base design, got shape "
                f"{tuple(self.base_budgets.shape)}")
        self.n_campaigns = self.base_budgets.shape[0]
        self.base_rule = base_rule or AuctionRule.first_price(
            self.n_campaigns, device=self.device)
        self._chunk_spec = as_chunk_spec(int(events_per_chunk))
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if store not in ("device", "host"):
            raise ValueError(
                f"unknown store: {store!r} (use 'device' or 'host')")
        self.store = store
        if store == "host":
            if placement != "batched" or mesh is not None:
                raise ValueError(
                    "store='host' replays through the host-stream pipeline "
                    "(placement='batched', no mesh); shard within a replay "
                    "via store='device' + placement='sharded' instead")
            if scenario_chunks is not None:
                raise ValueError(
                    "store='host' does not compose with scenario_chunks= "
                    "(the host-stream driver runs all lanes per pass)")
            if events_per_chunk % seg_lib.REDUCE_BLOCKS != 0:
                raise ValueError(
                    f"store='host' needs events_per_chunk to hold whole "
                    f"canonical reduction blocks: {events_per_chunk} is not "
                    f"a multiple of REDUCE_BLOCKS={seg_lib.REDUCE_BLOCKS}")
            # the replay chunk size aimed at; each replay realigns it to the
            # canonical grid of the log's size (_host_chunks)
            self._host_epc_target = (
                as_chunk_spec(chunks).events_per_chunk
                if chunks is not None else int(events_per_chunk))
            chunks = None
        self.plan = SweepPlan(placement=placement, resolve=resolve,
                              mesh=mesh, chunks=as_chunk_spec(chunks),
                              scenario_chunks=as_scenario_chunk_spec(
                                  scenario_chunks),
                              block_t="auto" if tuned else DEFAULT_BLOCK_T,
                              tuned=tuned)
        # the streaming folds: the batched program, the same resolve
        # preference (every back-end folds to the same bits)
        self._stream_plan = SweepPlan(placement="batched", resolve=resolve)
        self.log_version = 0
        self._slabs: List[torch.Tensor] = []
        self._n_events = 0
        self._values = None
        self._values_version = -1
        self._cache: Dict[Tuple[int, str],
                          Tuple[torch.Tensor, torch.Tensor]] = {}
        self.hits = 0
        self.misses = 0
        self.batches = 0
        self.appends = 0
        self._queue: List[Tuple[Ticket, AuctionRule, torch.Tensor]] = []
        self._seq = 0
        self._streams: Dict[str, _StreamGroup] = {}
        if events is not None:
            self.append(events)

    # -- the stored log ----------------------------------------------------

    @property
    def n_events(self) -> int:
        return self._n_events

    @property
    def values(self):
        """The whole stored log, the exact path's replay input: the slabs
        concatenated on the device (once per ``log_version``), or under
        ``store="host"`` a :class:`HostStream` of the pinned slabs (never
        concatenated, never on the card whole)."""
        if not self._slabs:
            raise ValueError(
                "empty log: append events before asking the service")
        if self.store == "host":
            return HostStream(list(self._slabs))
        if self._values_version != self.log_version:
            self._values = (self._slabs[0] if len(self._slabs) == 1
                            else torch.cat(self._slabs))
            self._values_version = self.log_version
        return self._values

    def _host_chunks(self, window: int, total: int) -> Optional[ChunkSpec]:
        """A host :class:`ChunkSpec` streaming ``window`` events of a log
        that holds (or will hold) ``total``: the largest whole-block chunk
        of at most the target that divides the window. A replay always has
        one; a fold window that starts inside a canonical block may not,
        and then ``None`` says to fold the slab on the card (the same
        bits)."""
        block = seg_lib.reduce_block_size(total)
        if window % block:
            return None
        m = window // block
        limit = max(self._host_epc_target // block, 1)
        k = max(d for d in range(1, min(m, limit) + 1) if m % d == 0)
        return ChunkSpec(block * k, source="host")

    def append(self, events) -> int:
        """Admit a slab of whole chunks; returns the new ``log_version``.
        Pending asks are answered first, against the log they were admitted
        under; then every streaming group folds the new rows and the cache
        is dropped."""
        events = torch.as_tensor(events, dtype=torch.float32)
        if events.ndim != 2 or events.shape[1] != self.n_campaigns:
            raise ValueError(
                f"append expects (n, C={self.n_campaigns}) event rows, got "
                f"shape {tuple(events.shape)}")
        if events.shape[0] == 0:
            raise ValueError("append needs at least one event row")
        check_append_alignment(self._chunk_spec, events.shape[0])
        self.flush()
        events = (host_slab(events) if self.store == "host"
                  else events.to(self.device))
        self._slabs.append(events)
        self._n_events += events.shape[0]
        self.log_version += 1
        self.appends += 1
        self._cache.clear()
        for group in self._streams.values():
            group.carry = self._fold(events, group.budgets, group.rules,
                                     group.carry)
        return self.log_version

    def _fold(self, slab, budgets, rules, carry) -> SweepCarry:
        """Fold one new slab into a streaming carry. Under ``store="host"``
        the slab streams from host memory when an aligned chunking of the
        fold window exists, and is folded on the card otherwise."""
        n_new = slab.shape[0]
        spec = (self._host_chunks(n_new, carry.n_events_seen + n_new)
                if self.store == "host" else None)
        if spec is not None:
            plan = dataclasses.replace(self._stream_plan, chunks=spec)
            _, carry = execute_sweep_resumable(HostStream([slab]), budgets,
                                               rules, plan, carry=carry)
            return carry
        _, carry = execute_sweep_resumable(slab.to(self.device), budgets,
                                           rules, self._stream_plan,
                                           carry=carry)
        return carry

    # -- admission batches (the exact path) --------------------------------

    def _normalise(self, rule: Optional[AuctionRule], budgets
                   ) -> Tuple[AuctionRule, torch.Tensor]:
        rule = rule or self.base_rule
        budgets = (self.base_budgets if budgets is None
                   else torch.as_tensor(budgets).to(self.device,
                                                    torch.float32))
        if tuple(budgets.shape) != (self.n_campaigns,) or \
                tuple(rule.multipliers.shape) != (self.n_campaigns,):
            raise ValueError(
                f"scenario shape mismatch: service serves C="
                f"{self.n_campaigns} campaigns, got multipliers "
                f"{tuple(rule.multipliers.shape)} / budgets "
                f"{tuple(budgets.shape)}")
        rule = AuctionRule(
            multipliers=rule.multipliers.to(self.device, torch.float32),
            reserve=torch.as_tensor(rule.reserve).to(self.device,
                                                     torch.float32),
            kind=rule.kind)
        return rule, budgets

    def ask(self, rule: Optional[AuctionRule] = None, budgets=None, *,
            label: Optional[str] = None) -> Ticket:
        """Admit one what-if design (the base design by default). Asks queue
        until :meth:`flush` or the first ``ticket.result()``."""
        rule, budgets = self._normalise(rule, budgets)
        fp = design_fingerprint(kind=rule.kind, multipliers=rule.multipliers,
                                reserve=rule.reserve, budgets=budgets)
        ticket = Ticket(seq=self._seq, fingerprint=fp,
                        label=label or f"ask{self._seq}", _service=self)
        self._seq += 1
        self._queue.append((ticket, rule, budgets))
        return ticket

    def flush(self) -> int:
        """Answer the queue: per pricing kind, the distinct uncached designs
        in ONE :func:`execute_sweep`, then every ticket its row in admission
        order. Returns the number of tickets answered."""
        if not self._queue:
            return 0
        pending, self._queue = self._queue, []
        version = self.log_version
        by_kind: Dict[str, List[Tuple[str, AuctionRule, torch.Tensor]]] = {}
        seen = set()
        for ticket, rule, budgets in pending:
            if (version, ticket.fingerprint) in self._cache or \
                    ticket.fingerprint in seen:
                self.hits += 1
                continue
            self.misses += 1
            seen.add(ticket.fingerprint)
            by_kind.setdefault(rule.kind, []).append(
                (ticket.fingerprint, rule, budgets))
        for lanes in by_kind.values():
            rules_s = sweep_lib.stack_rules([r for _, r, _ in lanes])
            budgets_s = torch.stack([b for _, _, b in lanes])
            spend, caps = self._execute_batch(rules_s, budgets_s)
            for i, (fp, _, _) in enumerate(lanes):
                self._cache[(version, fp)] = (spend[i], caps[i])
        for ticket, _, _ in pending:
            spend_row, caps_row = self._cache[(version, ticket.fingerprint)]
            ticket._answer = ServiceAnswer(final_spend=spend_row,
                                           cap_times=caps_row,
                                           log_version=version)
        return len(pending)

    def _batch_plan(self, n_lanes: int) -> Tuple[SweepPlan, int]:
        """The plan and padded lane count of one replay: an explicit
        ``scenario_chunks`` wins; otherwise more than ``max_batch`` lanes
        run scenario-chunked at ``max_batch``. Lanes are padded to whole
        chunks (times the mesh's scenario groups) with repeats of lane 0 (a
        duplicate lane runs the same per-lane program and changes no other
        lane's bits)."""
        plan = self.plan
        if self.store == "host":
            return dataclasses.replace(
                plan, chunks=self._host_chunks(self._n_events,
                                               self._n_events)), n_lanes
        spc = (plan.scenario_chunks.scenarios_per_chunk
               if plan.scenario_chunks is not None else None)
        if spc is None and n_lanes > self.max_batch:
            spc = self.max_batch
            plan = dataclasses.replace(
                plan, scenario_chunks=as_scenario_chunk_spec(spc))
        unit = spc or 1
        if plan.mesh is not None:
            d_sc = plan.mesh.scenario_device_count
            unit = unit * d_sc // math.gcd(unit, d_sc)
        return plan, -(-n_lanes // unit) * unit

    def _execute_batch(self, rules_s: AuctionRule, budgets_s: torch.Tensor,
                       overlay: Optional[ScenarioOverlay] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One exact replay of the whole stored log for a batch of lanes;
        returns (S, C) final spends and cap times, padding stripped."""
        n_lanes = budgets_s.shape[0]
        plan, n_pad = self._batch_plan(n_lanes)
        if n_pad > n_lanes:
            def pad(x):
                return torch.cat([x, x[:1].expand(
                    (n_pad - n_lanes,) + tuple(x.shape[1:]))])
            rules_s = AuctionRule(multipliers=pad(rules_s.multipliers),
                                  reserve=pad(rules_s.reserve),
                                  kind=rules_s.kind)
            budgets_s = pad(budgets_s)
            if overlay is not None:
                overlay = overlay.map_fields(pad)
        s_hat, cap_times, *_ = execute_sweep(self.values, budgets_s,
                                             rules_s, plan, overlay=overlay)
        self.batches += 1
        return s_hat[:n_lanes], cap_times[:n_lanes]

    # -- grid and family sweeps (what a service-bound engine routes here) --

    def sweep(self, grid, *, base_index: int = 0) -> SweepResult:
        """Evaluate a :class:`~repro_torch.core.counterfactual.ScenarioGrid`
        (or a :class:`~repro_torch.scenarios.CompiledFamily` compiled on
        this service's log) against the current log through the cache: the
        uncached scenarios run as ONE batched replay, bitwise the one-shot
        ``engine.sweep`` of the whole log."""
        overlay = None
        if isinstance(grid, CompiledFamily):
            family = grid
            if family.num_entrants:
                raise ValueError(
                    "entrant families extend the valuation matrix, but the "
                    "service's stored log is authoritative; recompile the "
                    "family without AddEntrant, or sweep it one-shot via "
                    "CounterfactualEngine.")
            if tuple(family.values.shape) != (self.n_events,
                                              self.n_campaigns):
                raise ValueError(
                    f"stale family: compiled over values of shape "
                    f"{tuple(family.values.shape)} but the service log is "
                    f"now ({self.n_events}, {self.n_campaigns}); recompile "
                    "from service.values after append().")
            fps = family_fingerprints(family)
            grid, overlay = family.grid, family.overlay
            base_index = family.base_index
        else:
            fps = grid_fingerprints(grid)
        self.values                      # raises on an empty log
        version = self.log_version
        missing: List[int] = []
        missing_fps: List[str] = []
        seen = set()
        for s, fp in enumerate(fps):
            if (version, fp) in self._cache or fp in seen:
                self.hits += 1
                continue
            self.misses += 1
            seen.add(fp)
            missing.append(s)
            missing_fps.append(fp)
        if missing:
            idx = torch.tensor(missing, device=grid.budgets.device)
            sub_rules = AuctionRule(
                multipliers=grid.rules.multipliers[idx],
                reserve=grid.rules.reserve.to(torch.float32).expand(
                    grid.num_scenarios)[idx],
                kind=grid.rules.kind)
            sub_overlay = None if overlay is None else \
                overlay.map_fields(lambda x: x[idx.to(x.device)])
            spend, caps = self._execute_batch(
                _on(sub_rules, self.device),
                grid.budgets[idx].to(self.device, torch.float32),
                overlay=sub_overlay)
            for i, fp in enumerate(missing_fps):
                self._cache[(version, fp)] = (spend[i], caps[i])
        rows = [self._cache[(version, fp)] for fp in fps]
        results = SimResult(final_spend=torch.stack([r[0] for r in rows]),
                            cap_times=torch.stack([r[1] for r in rows]))
        return SweepResult(grid=grid, results=results,
                           n_events=self.n_events, base_index=base_index)

    def engine(self) -> CounterfactualEngine:
        """A :class:`CounterfactualEngine` over the current log, bound to
        this service: its parallel ``sweep`` (and so ``search``) goes
        through the admission batch and the cache, with the unbound
        engine's bits. Make a new one after :meth:`append`: a stale one
        raises."""
        return CounterfactualEngine(self.values, self.base_budgets,
                                    self.base_rule, device=self.device,
                                    service=self)

    def tune(self, *, scenarios: Optional[int] = None, cache=None,
             cache_path=None, max_events: int = 4096, trials: int = 7,
             quick_trials: int = 3, top_k: int = 4, measure: bool = True):
        """One measured tuning pass on the stored log, then the winner
        pinned as this service's replay plan: candidates timed paired
        against the default plan at ``scenarios`` lanes (default
        ``max_batch``), the winner kept in the tuning cache, and
        ``self.plan`` the concrete tuned plan (stated chunk specs stay
        pinned). Every candidate answers with the same bits, so the answer
        cache keeps its entries. Returns the
        :class:`repro_torch.tune.TuneReport`."""
        from repro_torch import tune as tune_lib
        if self.store == "host":
            raise ValueError(
                "store='host' replans its chunking per log size "
                "(_host_chunks), so there is no stable plan to tune; "
                "construct the service with tuned=True instead — host "
                "replays then resolve their free knobs through the tuning "
                "cache at each ask.")
        self.flush()
        n_lanes = int(scenarios) if scenarios is not None else self.max_batch
        grid = ScenarioGrid.product(
            self.base_rule, self.base_budgets,
            bid_scales=tuple(1.0 + 0.25 * i for i in range(n_lanes)))
        plan = dataclasses.replace(self.plan, block_t="auto", tuned=True)
        report = tune_lib.autotune(
            self.values, grid.budgets, grid.rules, plan, cache=cache,
            cache_path=cache_path, max_events=max_events, trials=trials,
            quick_trials=quick_trials, top_k=top_k, measure=measure)
        self.plan = report.plan(plan)
        return report

    # -- streaming carries (the causal path) -------------------------------

    def register(self, label: str, rule: Optional[AuctionRule] = None,
                 budgets=None) -> None:
        """Register a design for streaming: its carry is caught up over the
        stored slabs once, then every :meth:`append` folds the new rows."""
        if any(label in g.labels for g in self._streams.values()):
            raise ValueError(f"streaming scenario {label!r} already "
                             "registered")
        rule, budgets = self._normalise(rule, budgets)
        lane_rules = sweep_lib.stack_rules([rule])
        lane_budgets = budgets[None, :]
        carry = initial_carry(1, self.n_campaigns, device=self.device)
        for slab in self._slabs:
            carry = self._fold(slab, lane_budgets, lane_rules, carry)
        group = self._streams.get(rule.kind)
        if group is None:
            self._streams[rule.kind] = _StreamGroup(
                labels=[label], rules=lane_rules, budgets=lane_budgets,
                carry=carry)
            return
        group.labels.append(label)
        group.rules = AuctionRule(
            multipliers=torch.cat([group.rules.multipliers,
                                   lane_rules.multipliers]),
            reserve=torch.cat([group.rules.reserve.reshape(-1),
                               lane_rules.reserve.reshape(-1)]),
            kind=rule.kind)
        group.budgets = torch.cat([group.budgets, lane_budgets])
        group.carry = SweepCarry(
            s_hat=torch.cat([group.carry.s_hat, carry.s_hat]),
            active=torch.cat([group.carry.active, carry.active]),
            cap_times=torch.cat([group.carry.cap_times, carry.cap_times]),
            n_hat=torch.cat([group.carry.n_hat, carry.n_hat]),
            n_events_seen=self._n_events)

    def streaming(self, label: str) -> ServiceAnswer:
        """The registered design's current causal estimate, without a
        replay. Bitwise :meth:`ask` when the whole log arrived in one
        append."""
        for group in self._streams.values():
            if label in group.labels:
                i = group.labels.index(label)
                return ServiceAnswer(final_spend=group.carry.s_hat[i],
                                     cap_times=group.carry.cap_times[i],
                                     log_version=self.log_version)
        raise ValueError(
            f"unknown streaming scenario: {label!r} (registered: "
            f"{[l for g in self._streams.values() for l in g.labels]})")

    # -- checkpoints --------------------------------------------------------

    def save(self, path):
        """Checkpoint the whole service under ``path``, one directory per
        ``log_version`` (:func:`~repro_torch.checkpoint.save_checkpoint`,
        ``repro``'s leaves and manifest): the slabs, the base design, and
        every streaming group's designs and carry. Pending asks are
        answered first. Returns the checkpoint directory."""
        self.flush()
        tree = {
            "slabs": list(self._slabs),
            "base_budgets": self.base_budgets,
            "base_multipliers": self.base_rule.multipliers,
            "base_reserve": self.base_rule.reserve,
            "streams": {
                kind: {
                    "multipliers": g.rules.multipliers,
                    "reserve": g.rules.reserve.reshape(-1),
                    "budgets": g.budgets,
                    "s_hat": g.carry.s_hat,
                    "active": g.carry.active,
                    "cap_times": g.carry.cap_times,
                    "n_hat": g.carry.n_hat,
                } for kind, g in self._streams.items()},
        }
        extra = {
            "log_version": self.log_version,
            "n_events": self._n_events,
            "n_slabs": len(self._slabs),
            "n_campaigns": self.n_campaigns,
            "events_per_chunk": self._chunk_spec.events_per_chunk,
            "max_batch": self.max_batch,
            "store": self.store,
            "base_kind": self.base_rule.kind,
            "seq": self._seq,
            "stream_labels": {k: list(g.labels)
                              for k, g in self._streams.items()},
            "stream_n_seen": {k: int(g.carry.n_events_seen)
                              for k, g in self._streams.items()},
            "counters": {"hits": self.hits, "misses": self.misses,
                         "batches": self.batches, "appends": self.appends},
        }
        return save_checkpoint(path, self.log_version, tree, extra)

    @classmethod
    def load(cls, path, *, step: Optional[int] = None,
             placement: str = "batched", resolve: str = "auto", mesh=None,
             chunks=None, scenario_chunks=None, tuned: bool = False,
             device: DeviceLike = None) -> "CounterfactualService":
        """Restore a service saved by :meth:`save` (by either package): the
        latest checkpoint under ``path``, or ``step`` (a log version). The
        slabs, base design, log version and carries come back exactly; the
        plan's knobs are this process's choice (every plan answers with the
        same bits). The cache starts empty."""
        if step is None:
            step = latest_step(path)
            if step is None:
                raise FileNotFoundError(
                    f"no service checkpoints under {path}")
        dev = pick_device(device)
        # the manifest names the tree (slab count, stream kinds), then the
        # tree restores into it
        _, manifest = restore_checkpoint(path, {}, step=step, device=dev)
        extra = manifest["extra"]
        kinds = list(extra["stream_labels"])
        like = {
            "slabs": [0] * int(extra["n_slabs"]),
            "base_budgets": 0, "base_multipliers": 0, "base_reserve": 0,
            "streams": {kind: {"multipliers": 0, "reserve": 0,
                               "budgets": 0, "s_hat": 0, "active": 0,
                               "cap_times": 0, "n_hat": 0}
                        for kind in kinds},
        }
        host = extra["store"] == "host"
        tree, _ = restore_checkpoint(path, like, step=step,
                                     device="cpu" if host else dev)
        on = (lambda x: x.to(dev)) if host else (lambda x: x)
        base_rule = AuctionRule(multipliers=on(tree["base_multipliers"]),
                                reserve=on(tree["base_reserve"]),
                                kind=extra["base_kind"])
        svc = cls(on(tree["base_budgets"]), base_rule,
                  events_per_chunk=int(extra["events_per_chunk"]),
                  max_batch=int(extra["max_batch"]), placement=placement,
                  resolve=resolve, mesh=mesh, chunks=chunks,
                  scenario_chunks=scenario_chunks, store=extra["store"],
                  tuned=tuned, device=dev)
        svc._slabs = [host_slab(s) if host else s for s in tree["slabs"]]
        svc._n_events = int(extra["n_events"])
        svc.log_version = int(extra["log_version"])
        svc._seq = int(extra["seq"])
        counters = extra["counters"]
        svc.hits, svc.misses = int(counters["hits"]), int(counters["misses"])
        svc.batches = int(counters["batches"])
        svc.appends = int(counters["appends"])
        for kind in kinds:
            g = {k: on(v) for k, v in tree["streams"][kind].items()}
            svc._streams[kind] = _StreamGroup(
                labels=list(extra["stream_labels"][kind]),
                rules=AuctionRule(multipliers=g["multipliers"],
                                  reserve=g["reserve"], kind=kind),
                budgets=g["budgets"],
                carry=SweepCarry(
                    s_hat=g["s_hat"], active=g["active"],
                    cap_times=g["cap_times"], n_hat=g["n_hat"],
                    n_events_seen=int(extra["stream_n_seen"][kind])))
        return svc

    # -- observability -------------------------------------------------------

    @property
    def stats(self) -> dict:
        """Hit and miss counters and the log's bookkeeping."""
        return {"log_version": self.log_version, "n_events": self.n_events,
                "hits": self.hits, "misses": self.misses,
                "batches": self.batches, "appends": self.appends,
                "pending": len(self._queue),
                "cached": len(self._cache),
                "registered": sum(len(g.labels)
                                  for g in self._streams.values())}


def _on(rules: AuctionRule, device) -> AuctionRule:
    return AuctionRule(multipliers=rules.multipliers.to(device),
                       reserve=rules.reserve.to(device), kind=rules.kind)
