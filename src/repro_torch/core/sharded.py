"""Event-sharded drivers of the paper's algorithms (port of
``repro.core.sharded``).

The paper frames Algorithm 2 and SORT2AGGREGATE as MapReduce over the event
log: the log is split over the event ranks of a mesh
(:class:`repro_torch.launch.mesh.SweepMeshSpec`; rank ``r`` holds global
events ``[r·local_n, (r+1)·local_n)`` on its device), campaign state (pi,
spends, budgets: O(C)) stays whole, and every algorithm is the one-device
version with its reductions summed over the ranks in rank order — ``repro``'s
``psum``, which XLA's CPU backend adds in that order too:

* :func:`make_sharded_kernels` — the rate and block closures of the
  Algorithm-2 host driver (``parallel_simulate(driver="host")``): each
  shard's canonical ``(32, C)`` partials at its offset, added (each block
  is one shard's, so the sum is exact);
* :func:`sweep_sharded` — the sharded scenario sweep, the executor's
  ``placement="sharded"`` (bit for bit the batched sweep);
* :func:`sharded_aggregate` / :func:`sharded_first_crossing` —
  SORT2AGGREGATE's aggregate step: every shard resolved under its segment
  masks at its offset, its flat sums added over the shards, and the
  crossing diagnosed shard by shard from the prefix of the shards before
  it (``repro``'s all-gathered exclusive prefix) with ONE scan over the
  shard (``s0 + cumsum``; on CUDA a ``first_crossing`` call with a carry at
  ``block = local_n``);
* :func:`sweep_first_crossing_sharded` / :func:`sweep_sort2aggregate_sharded`
  — the scenario-batched crossing and the SORT2AGGREGATE sweep (refine and
  aggregate), every pass over the shards (one ``segment_resolve`` launch
  and one ``first_crossing`` call a shard on CUDA);
* :func:`estimate_pi_sharded` — Algorithm 4 with the minibatch residual
  summed over the shards every step: each rank draws its own minibatch
  from its own rows (``fold_in(key, offset)``), so it runs step by step
  (the persistent ``vi`` launch cannot span ranks); on CUDA each step
  resolves every shard's rows on one device in one MatrixTile
  ``auction_resolve`` launch and their flat sums in one ``first_crossing``
  call.

Every function takes the event axes as an ordered sequence (the row-major
contract of ``repro``) and a mesh, a tensor or a
:class:`~repro_torch.launch.mesh.ShardedLog`; results are on the mesh's
lead device. On the CPU the cap times, pi and spends are ``repro``'s bits
(``tests/test_torch_sharded.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch import prng
from repro_torch.core import auction
from repro_torch.core import segments as seg_lib
from repro_torch.core.executor import (_on, check_shard_layout,
                                       check_sharded_shapes, execute_sweep,
                                       shard_log)
from repro_torch.core.types import (AuctionRule, Segments, SimResult,
                                    never_capped)
from repro_torch.floats import fma
from repro_torch.kernels.auction_resolve import ops as resolve_ops
from repro_torch.launch.mesh import (EventSharding, Mesh, ShardedLog,
                                     SweepMeshSpec, event_sharding)

__all__ = ["event_sharding", "shard_events", "make_sharded_kernels",
           "sharded_aggregate", "sharded_first_crossing",
           "estimate_pi_sharded", "sweep_sharded",
           "sweep_first_crossing_sharded", "sweep_sort2aggregate_sharded"]


def _spec(mesh, event_axes: Sequence[str]) -> SweepMeshSpec:
    if isinstance(mesh, SweepMeshSpec):
        return mesh
    return SweepMeshSpec(mesh, event_axes=tuple(event_axes))


def shard_events(values, mesh: Mesh,
                 event_axes: Sequence[str] = ("data",)) -> ShardedLog:
    """(N, C) values with events split over ``event_axes`` of ``mesh``
    (views of ``values`` on the ranks whose device it is on)."""
    return EventSharding(_spec(mesh, event_axes)).place(values)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def make_sharded_kernels(mesh: Mesh, rule: AuctionRule,
                         event_axes: Sequence[str] = ("data",)):
    """``(rate_fn, block_fn)`` closures for the Algorithm-2 host driver:
    ``rate_fn(values)(active, lo)`` and ``block_fn(values)(active, lo,
    hi)``. Each resolves every shard under the (C,) activation, reduces
    its rows onto the canonical ``(32, C)`` partials at its offset
    (``segment_partials`` on CUDA) and adds the shards' partials in rank
    order — exact, because each block is one shard's on an aligned mesh —
    before the in-order fold. So ``parallel_simulate(driver="host")`` fed
    these is bit for bit the one-device drivers."""
    spec = _spec(mesh, event_axes)

    def partials(values, active, weight_of):
        n_events, n_campaigns = values.shape
        block = seg_lib.reduce_block_size(n_events)
        home = spec.lead_device
        acc = None
        for offset, v in shard_log(values, spec):
            dev = v.device
            winners, prices = auction.resolve(v, _on(active, dev), AuctionRule(
                multipliers=_on(rule.multipliers, dev),
                reserve=_on(torch.as_tensor(rule.reserve), dev),
                kind=rule.kind))
            gidx = offset + torch.arange(v.shape[0], dtype=torch.int32,
                                         device=dev)
            parts = _on(seg_lib.partial_spend_sums(
                winners, prices, n_campaigns,
                weight_of(gidx).to(prices.dtype), block_size=block,
                index_offset=offset), home)
            acc = parts if acc is None else acc + parts
        return acc, n_events

    def rate_fn(values):
        def f(active, lo):
            lo = int(lo)
            parts, n_events = partials(values, active, lambda g: g >= lo)
            sums = seg_lib.fold_blocks(parts)
            return sums / torch.tensor(float(max(n_events - lo, 1)),
                                       dtype=sums.dtype, device=sums.device)
        return f

    def block_fn(values):
        def f(active, lo, hi):
            lo, hi = int(lo), int(hi)
            parts, _ = partials(values, active,
                                lambda g: (g >= lo) & (g < hi))
            return seg_lib.fold_blocks(parts)
        return f

    return rate_fn, block_fn


def _batched_first_crossing(parts, budgets: torch.Tensor, n_events: int,
                            n_campaigns: int):
    """The sharded crossing of S lanes (``repro``'s
    ``_batched_first_crossing``) from every shard's resolved rows ``parts``
    (``[(offset, winners (S, n), prices (S, n))]`` in rank order): shard
    ``r`` is scanned from ``s0`` = the flat sums of the shards before it,
    added in rank order (``repro``'s all-gathered prefix, whose zero terms
    change nothing), and a campaign keeps the first shard's crossing
    (``pmin``). The totals are the same chain run to the last shard: the
    ``psum`` of the flat sums, which XLA's CPU backend adds in rank order.
    Returns ``(totals (S, C), cap times (S, C))`` on the budgets'
    device."""
    home = budgets.device
    s = budgets.shape[0]
    total = torch.zeros((s, n_campaigns), dtype=torch.float32, device=home)
    cap = torch.full((s, n_campaigns), never_capped(n_events),
                     dtype=torch.int32, device=home)
    for r, (offset, winners, prices) in enumerate(parts):
        dev = winners.device
        sums, cap = seg_lib.shard_crossing(
            winners, prices, _on(budgets, dev), n_campaigns,
            s0=_on(total, dev), cap=_on(cap, dev), offset=offset,
            n_global=n_events)
        sums, cap = _on(sums, home), _on(cap, home)
        total = sums if r == 0 else total + sums
    return total, cap


def sharded_aggregate(mesh: Mesh, values, segments: Segments,
                      budgets: torch.Tensor, rule: AuctionRule,
                      event_axes: Sequence[str] = ("data",)) -> SimResult:
    """SORT2AGGREGATE Step 3 on the mesh: every shard resolved under its
    events' segment masks at its offset (one ``segment_resolve`` launch a
    shard on CUDA), the flat sums added over the shards, the crossing
    diagnosed shard by shard (:func:`_batched_first_crossing`). Returns a
    :class:`SimResult` with (C,) spends and cap times, no per-event
    winners or prices (an (N,) gather)."""
    spec = _spec(mesh, event_axes)
    n_events, n_campaigns = values.shape
    check_shard_layout(n_events, 1, spec, require_block_alignment=False)
    home = spec.lead_device
    b = _f32(budgets, home).reshape(1, n_campaigns)
    mult = _f32(rule.multipliers, home).reshape(1, n_campaigns)
    res = _f32(rule.reserve, home).reshape(1)
    parts = []
    for offset, v in shard_log(values, spec):
        dev = v.device
        winners, prices = resolve_ops.segment_resolve(
            v, mult, res, segments.boundaries.reshape(1, -1),
            segments.masks[None], second_price=rule.kind == "second_price",
            offset=offset)
        parts.append((offset, winners, prices))
    total, cap = _batched_first_crossing(parts, b, n_events, n_campaigns)
    return SimResult(final_spend=total[0], cap_times=cap[0], winners=None,
                     prices=None, segments=segments)


def sharded_first_crossing(mesh: Mesh, values, segments: Segments,
                           budgets: torch.Tensor, rule: AuctionRule,
                           event_axes: Sequence[str] = ("data",)
                           ) -> torch.Tensor:
    """The cap times of :func:`sharded_aggregate`."""
    return sharded_aggregate(mesh, values, segments, budgets, rule,
                             event_axes).cap_times


def _shard_draws(key: torch.Tensor, offset: int, local_n: int, *,
                 num_iters: int, local_batch: int, width: int):
    """One rank's draws of Algorithm 4 at scale, ``repro``'s bits: the key
    folded with the rank's offset, split into one key a step, each split
    again into the minibatch's rows (``randint`` over the rank's rows) and
    its uniforms ((B, 1) shared, (B, C) independent). Returns ``(rows
    (T, B) int64, u (T, B, width) float32)``."""
    dev_key = prng.fold_in(key, offset)
    pairs = prng.split(prng.split(dev_key, num_iters))      # (T, 2, 2)
    rows = prng.randint(pairs[:, 0], (local_batch,), 0, local_n)
    u = prng.uniform(pairs[:, 1], (local_batch, width))
    return rows.long(), u


def estimate_pi_sharded(mesh: Mesh, values, budgets: torch.Tensor,
                        rule: AuctionRule, key: torch.Tensor, *,
                        num_iters: int = 200, local_batch: int = 64,
                        eta: float = 0.5, eta_decay: float = 0.0,
                        pi0: Optional[torch.Tensor] = None,
                        event_axes: Sequence[str] = ("data",),
                        coupling: str = "shared") -> torch.Tensor:
    """Algorithm 4 at scale (``repro``'s ``estimate_pi_sharded``): every
    rank draws a ``local_batch`` minibatch from its own rows each step
    (:func:`_shard_draws`), the ranks' spend sums are added in rank order,
    and pi takes ``eta_t · global_batch · (b/N - mean spend)``, ``eta_t =
    eta / (1 + eta_decay · t)``, ``global_batch = local_batch × ranks``.
    The returned (C,) pi is the mean over the ranks of their identical
    copies (``repro``'s ``pmean``: a sum in rank order, then a divide, which
    can move the last bit). ``coupling="shared"`` draws one uniform an
    event, anything else one an (event, campaign)."""
    spec = _spec(mesh, event_axes)
    n_events, n_campaigns = values.shape
    check_shard_layout(n_events, 1, spec, require_block_alignment=False)
    home = spec.lead_device
    f32 = dict(dtype=torch.float32, device=home)
    btilde = _f32(budgets, home) / torch.tensor(float(n_events), **f32)
    pi = torch.ones(n_campaigns, **f32) if pi0 is None else _f32(pi0, home)
    shards = shard_log(values, spec)
    d_ev = len(shards)
    local_n = n_events // d_ev
    width = 1 if coupling == "shared" else n_campaigns
    global_batch = torch.tensor(float(local_batch * d_ev), **f32)
    second = rule.kind == "second_price"
    # each device's shards stacked: one resolve a device a step
    groups = {}
    for rank, (offset, v) in enumerate(shards):
        rows, u = _shard_draws(_on(key, v.device), offset, local_n,
                               num_iters=num_iters, local_batch=local_batch,
                               width=width)
        groups.setdefault(v.device, []).append((rank, v[rows], u))
    stacked = {dev: ([r for r, _, _ in g],
                     torch.cat([s for _, s, _ in g], dim=1),
                     torch.cat([u for _, _, u in g], dim=1))
               for dev, g in groups.items()}
    rules_on = {dev: (_f32(rule.multipliers, dev), _f32(rule.reserve, dev))
                for dev in stacked}
    eta32 = torch.tensor(eta, **f32)
    for t in range(num_iters):
        eta_t = eta32 / fma(torch.tensor(eta_decay, **f32),
                            torch.tensor(float(t), **f32),
                            torch.ones((), **f32))
        by_rank = [None] * d_ev
        for dev, (ranks, sampled, u) in stacked.items():
            mult, res = rules_on[dev]
            active = u[t] < _on(pi, dev)[None, :]
            winners, prices, _ = resolve_ops.resolve_masked(
                sampled[t], mult, active, res, second_price=second,
                sums=False)
            sums = _on(auction.spend_sums(
                winners.reshape(len(ranks), local_batch),
                prices.reshape(len(ranks), local_batch), n_campaigns), home)
            for rank, row in zip(ranks, sums):
                by_rank[rank] = row
        total = by_rank[0]
        for row in by_rank[1:]:
            total = total + row
        mean_spend = total / global_batch
        pi = torch.clamp(fma(eta_t * global_batch, btilde - mean_spend, pi),
                         0.0, 1.0)
    acc = pi
    for _ in range(d_ev - 1):
        acc = acc + pi
    return acc / torch.tensor(float(d_ev), **f32)


def sweep_sharded(values, budgets: torch.Tensor, rules: AuctionRule,
                  spec: SweepMeshSpec, resolve: str = "auto",
                  skip_retired: bool = True, chunks=None,
                  scenario_chunks=None):
    """The batched Algorithm-2 loop on the mesh (``placement="sharded"``):
    events over ``spec.event_axes``, scenarios over ``spec.scenario_axis``
    when it has one; ``chunks`` scans each shard's own rows a chunk at a
    time, ``scenario_chunks`` each scenario group's lanes. Returns
    :func:`~repro_torch.core.executor.execute_sweep`'s batched tuple, bit
    for bit the batched sweep on an aligned mesh."""
    return execute_sweep(values, budgets, rules, spec.plan(
        resolve=resolve, skip_retired=skip_retired, chunks=chunks,
        scenario_chunks=scenario_chunks))


def _sweep_s2a_program(values, caps0: torch.Tensor, budgets: torch.Tensor,
                       rules: AuctionRule, spec: SweepMeshSpec,
                       refine_iters: int):
    """``(totals (S, C), diagnosed cap times (S, C), assumed cap times
    (S, C), iterations that moved each lane (S,))`` after ``refine_iters``
    fixed-point iterations of the segment history on the mesh, one
    scenario group at a time. Each replay resolves every shard under each
    lane's masks at its offset (:func:`repro_torch.kernels.auction_resolve.
    ops.segment_resolve`) and diagnoses the crossings shard by shard
    (:func:`_batched_first_crossing`)."""
    n_events, n_campaigns = values.shape
    sentinel = never_capped(n_events)
    home = spec.lead_device
    n_scenarios = budgets.shape[0]
    d_sc = spec.scenario_device_count
    s_loc = n_scenarios // d_sc
    second = rules.kind == "second_price"
    reserves = _f32(rules.reserve, home).expand(n_scenarios)
    caps0 = torch.as_tensor(caps0).to(home, torch.int32)
    outs = []
    for group in range(d_sc):
        lanes = slice(group * s_loc, (group + 1) * s_loc)
        shards = shard_log(values, spec, group)
        mult = _f32(rules.multipliers[lanes], home)
        res = reserves[lanes]
        b = _f32(budgets[lanes], home)

        def replay(caps):
            segs = Segments.from_cap_times(caps, n_events)
            parts = []
            for offset, v in shards:
                dev = v.device
                winners, prices = resolve_ops.segment_resolve(
                    v, _on(mult, dev), _on(res, dev),
                    _on(segs.boundaries, dev), _on(segs.masks, dev),
                    second_price=second, offset=offset)
                parts.append((offset, winners, prices))
            return _batched_first_crossing(parts, b, n_events, n_campaigns)

        caps = torch.clamp(caps0[lanes], max=sentinel)
        iters = torch.zeros(caps.shape[0], dtype=torch.int32, device=home)
        for _ in range(refine_iters):
            _, diag = replay(caps)
            new = torch.clamp(diag, max=sentinel)
            iters = iters + (new != caps).any(-1).to(torch.int32)
            caps = new
        totals, diag = replay(caps)
        outs.append((totals, diag, caps, iters))
    return tuple(torch.cat(x) for x in zip(*outs))


def sweep_first_crossing_sharded(values, cap_times: torch.Tensor,
                                 budgets: torch.Tensor, rules: AuctionRule,
                                 spec: SweepMeshSpec) -> torch.Tensor:
    """Each scenario's budget-crossing times under its assumed cap times
    (S, C), on the mesh: the engine of the sharded refine step. Returns
    (S, C) 1-based crossing times (``N+1`` = never)."""
    check_sharded_shapes(values, budgets, rules, spec,
                         require_block_alignment=False)
    _, caps, _, _ = _sweep_s2a_program(values, cap_times, budgets, rules,
                                       spec, refine_iters=0)
    return caps


def sweep_sort2aggregate_sharded(values, budgets: torch.Tensor,
                                 rules: AuctionRule, spec: SweepMeshSpec,
                                 cap_times_init=None, refine_iters: int = 8
                                 ) -> Tuple[SimResult, torch.Tensor,
                                            torch.Tensor]:
    """SORT2AGGREGATE over a scenario batch on the mesh: per-scenario
    fixed-point refinement of the cap times from ``cap_times_init`` ((S, C)
    or (C,); the all-active start when None), then one aggregate pass,
    every pass over the shards. The spends are plain sums over the shards
    (``repro``'s, which may differ from the one-device sweep's in the last
    ulp); the cap times are integer decisions. Returns ``(results, gaps
    (S,) float32, refine_iters_used (S,) int32)``, ``gaps[s]`` the largest
    |assumed - replayed| cap time of lane s."""
    check_sharded_shapes(values, budgets, rules, spec,
                         require_block_alignment=False)
    n_events, n_campaigns = values.shape
    n_scenarios = budgets.shape[0]
    home = spec.lead_device
    if cap_times_init is None:
        cap_times_init = torch.full((n_campaigns,), n_events + 1,
                                    dtype=torch.int32)
    caps0 = torch.as_tensor(cap_times_init).to(home, torch.int32).expand(
        n_scenarios, n_campaigns)
    totals, diag, assumed, iters = _sweep_s2a_program(
        values, caps0, budgets, rules, spec, refine_iters=refine_iters)
    sentinel = never_capped(n_events)
    gaps = (torch.clamp(diag, max=sentinel) - assumed).abs().to(
        torch.float32).amax(-1)
    result = SimResult(final_spend=totals, cap_times=diag, winners=None,
                       prices=None, segments=None)
    return result, gaps, iters
