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

The round loop (:func:`_run_loop`) is a Python loop that checks once per
round whether any lane is alive — one host sync per round; capturing the
loop in a CUDA graph is later work. Axes ``repro`` has and this port does
not yet (event ``chunks``, ``scenario_chunks``, the ``sharded`` and
``multihost`` placements, ``tuned`` plans, overlays) raise
``NotImplementedError`` naming the ROADMAP item that ports them; the port
names its resolve back-ends after what they run, so ``repro``'s ``"jnp"``
and ``"pallas"`` are unknown options here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import auction
from repro_torch.core import segments as seg_lib
from repro_torch.core.sort2aggregate import refine_fixed_lanes
from repro_torch.core.types import AuctionRule, never_capped
from repro_torch.kernels.auction_resolve import ops as resolve_ops

RESOLVE_BACKENDS = ("torch", "sweep_resolve", "fused")
# the CUDA back-end of a C above the round kernels' shared memory; chosen by
# pick_resolve, never named by a caller
ANY_C_BACKEND = "auction_resolve"
PLACEMENTS = ("device", "batched")
SIM_DRIVERS = ("auto", "device", "host")

# axes of repro's executor this port has not reached, and where ROADMAP.md
# queues them
UNPORTED = {
    "placement='sharded'": "queue 1, item 8 (multi-GPU placements)",
    "placement='multihost'": "queue 1, item 8 (multi-GPU placements)",
    "chunks": "queue 1, item 3 (execution axes on one GPU)",
    "scenario_chunks": "queue 1, item 3 (execution axes on one GPU)",
    "tuned": "queue 1, item 9 (tuning)",
    "overlay": "queue 1, item 5 (CRN scenario families)",
    "mesh": "queue 1, item 8 (multi-GPU placements)",
}


def _unknown(kind: str, got, known) -> ValueError:
    """THE unknown-option error, with ``repro``'s message text."""
    names = ", ".join(repr(k) for k in known)
    return ValueError(f"unknown {kind}: {got!r} (choose from {names})")


def not_ported(axis: str) -> NotImplementedError:
    return NotImplementedError(
        f"{axis} is not ported to repro_torch yet; see ROADMAP.md "
        f"{UNPORTED[axis]}")


def reject_unported(**axes) -> None:
    """Raise for any not-yet-ported axis given a non-default value."""
    for name, value in axes.items():
        if value not in (None, False):
            raise not_ported(name)


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
class SweepPlan:
    """Everything that decides which Algorithm-2 program runs:
    ``placement`` (``"batched"`` | ``"device"``), ``resolve`` (``"torch"``
    | ``"sweep_resolve"`` | ``"fused"`` | ``"auto"``) and
    ``skip_retired``."""

    placement: str = "batched"
    resolve: str = "auto"
    skip_retired: bool = True

    def __post_init__(self):
        if f"placement={self.placement!r}" in UNPORTED:
            raise not_ported(f"placement={self.placement!r}")
        if self.placement not in PLACEMENTS:
            raise _unknown("placement", self.placement, PLACEMENTS)
        if self.resolve not in RESOLVE_BACKENDS + ("auto",):
            raise _unknown("resolve back-end", self.resolve,
                           RESOLVE_BACKENDS + ("auto",))


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
    for name, t in (("budgets", budgets), ("multipliers", rules.multipliers),
                    ("reserve", rules.reserve)):
        if t.device != values.device:
            raise ValueError(f"{name} is on {t.device} but values are on "
                             f"{values.device}; put a sweep on one device")


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

def _make_round_body(plan: SweepPlan, resolve: str, *, values, rules,
                     budgets_f32, n_events: int, n_campaigns: int):
    """The per-round map ``round_body(core, keep) -> core'`` for the
    ``"torch"``, ``"sweep_resolve"`` or :data:`ANY_C_BACKEND` (resolve-once)
    or ``"fused"`` back-end."""
    sentinel = never_capped(n_events)
    second = rules.kind == "second_price"
    block = seg_lib.reduce_block_size(n_events)
    b = budgets_f32
    reserves = rules.reserve.to(torch.float32).expand(b.shape[0])

    def resolve_lanes(active):
        """(S, N) winners/prices of every lane: one ``sweep_resolve`` or,
        for :data:`ANY_C_BACKEND`, one ``auction_resolve`` launch (and its
        chunk merge) for all lanes, or the torch path one lane at a time
        (the bids tensor is then (N, C), never (S, N, C))."""
        if resolve == "sweep_resolve":
            winners, prices, _ = resolve_ops.sweep_resolve(
                values, rules.multipliers, active, reserves,
                second_price=second)
            return winners, prices
        if resolve == ANY_C_BACKEND:
            return resolve_ops.resolve_lanes(values, rules.multipliers,
                                             active, reserves,
                                             second_price=second)
        out = [auction.resolve(values, active[s], AuctionRule(
            multipliers=rules.multipliers[s], reserve=reserves[s],
            kind=rules.kind)) for s in range(active.shape[0])]
        return (torch.stack([w for w, _ in out]),
                torch.stack([p for _, p in out]))

    def weighted_partials(winners, prices, lo, hi):
        """(S, G, C) canonical partials of the events in ``[lo, hi)``."""
        return seg_lib.window_partials(winners, prices, n_campaigns, lo, hi,
                                       block_size=block)

    def round_body(core, keep):
        s_hat, active, cap, n_hat, rnd, retired, bnds = core
        if resolve == "fused":
            _, block_parts, c_next, no_cap, n_next = resolve_ops.round_fused(
                values, rules.multipliers, active, reserves, b, s_hat,
                n_hat, keep, reduce_blocks=seg_lib.REDUCE_BLOCKS,
                second_price=second, skip_retired=plan.skip_retired)
        else:
            winners, prices = resolve_lanes(active)
            rate_parts = weighted_partials(winners, prices, n_hat,
                                           torch.full_like(n_hat, n_events))
            denom = torch.clamp(n_events - n_hat, min=1).to(torch.float32)
            rates = seg_lib.fold_blocks(rate_parts) / denom[:, None]
            c_next, no_cap, n_next = lane_predict(rates, b, s_hat, active,
                                                  n_hat, n_events=n_events)
            block_parts = weighted_partials(winners, prices, n_hat, n_next)
        blk = seg_lib.fold_blocks(block_parts)
        return lane_commit(blk, c_next, no_cap, n_next, s_hat, active, cap,
                           rnd, retired, bnds, sentinel=sentinel)

    return round_body


def _alive(core, *, n_events: int, n_campaigns: int) -> torch.Tensor:
    _, active, _, n_hat, rnd, _, _ = core
    return (rnd < n_campaigns + 1) & (n_hat < n_events) & active.any(-1)


def _run_loop(round_body, *, n_scenarios: int, n_events: int,
              n_campaigns: int, device):
    """Run rounds until every lane has retired its last cap-out (at most
    C+1), freezing finished lanes with ``torch.where``. One host sync per
    round, for the alive check. Returns the carried core state."""
    s, c = n_scenarios, n_campaigns
    i32 = dict(dtype=torch.int32, device=device)
    core = (
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


def _sweep_batched(values, budgets, rules, plan: SweepPlan):
    """The scenario-batched Algorithm-2 loop on one device."""
    check_batch_shapes(values, budgets, rules)
    n_events, n_campaigns = values.shape
    resolve = pick_resolve(plan.resolve, values.device, n_campaigns)
    budgets_f32 = budgets.to(torch.float32)
    round_body = _make_round_body(
        plan, resolve, values=values, rules=rules, budgets_f32=budgets_f32,
        n_events=n_events, n_campaigns=n_campaigns)
    core = _run_loop(round_body, n_scenarios=budgets.shape[0],
                     n_events=n_events, n_campaigns=n_campaigns,
                     device=values.device)
    return _unpack(core)


def execute_sweep(values, budgets, rules, plan: SweepPlan, *, overlay=None):
    """Run the Algorithm-2 sweep program described by ``plan``.

    ``placement="batched"`` takes budgets (S, C) and a stacked rule and
    returns ``(s_hat (S, C) float32, cap_times (S, C) int32, retired
    (S, C+1) int32, boundaries (S, C+2) int32, num_rounds (S,) int32,
    n_hat (S,) int32)``; ``placement="device"`` takes one scenario (budgets
    (C,), an unstacked rule) and returns the unbatched tuple.
    """
    reject_unported(overlay=overlay)
    if plan.placement == "device":
        rules_b = AuctionRule(multipliers=rules.multipliers[None, :],
                              reserve=rules.reserve.reshape(1),
                              kind=rules.kind)
        out = _sweep_batched(values, budgets[None, :], rules_b,
                             dataclasses.replace(plan, placement="batched"))
        return tuple(x[0] for x in out)
    return _sweep_batched(values, budgets, rules, plan)


# ---------------------------------------------------------------------------
# The SORT2AGGREGATE sweep
# ---------------------------------------------------------------------------

def check_s2a_options(plan: SweepPlan, record_events: bool = False, *,
                      chunks=None, scenario_chunks=None) -> None:
    """Validate the SORT2AGGREGATE sweep's plan (callable up front, so an
    engine can fail fast before paying for a warm start). ``chunks`` and
    ``scenario_chunks`` stand for the fields of ``repro``'s plan that the
    port's :class:`SweepPlan` does not have yet; the errors ``repro``
    raises for them are raised with its texts, and chunked replays
    otherwise raise ``NotImplementedError``."""
    if chunks is not None:
        if record_events:
            raise ValueError(
                "record_events is not supported with chunks= on the "
                "sort2aggregate sweep: per-event winners/prices of the "
                "whole log are the O(N·C) residency chunking avoids. Drop "
                "record_events (spends/cap times stream fine) or drop "
                "chunks=.")
        reject_unported(chunks=chunks)
    if scenario_chunks is not None:
        raise ValueError(
            "scenario_chunks= (scenario-chunked execution) currently "
            "applies to method='parallel' sweeps only; drop "
            "scenario_chunks= for the sort2aggregate sweep.")


def execute_s2a_sweep(values, budgets, rules, plan: SweepPlan, *,
                      cap_times_init=None, refine_iters: int = 8,
                      record_events: bool = False,
                      crossing_block: int = 4096, chunks=None,
                      scenario_chunks=None):
    """Run the SORT2AGGREGATE scenario sweep: every lane refined from its
    warm start (``cap_times_init`` (S, C) or (C,); all-active when None)
    for ``refine_iters`` fixed-point iterations, then aggregated. Both
    placements run the lanes batched: each pass resolves the lanes one at a
    time and finds every lane's crossings in one launch. Returns
    ``(SimResult (S, ...), consistency_gaps (S,) float32, refine_iters_used
    (S,) int32)``."""
    check_s2a_options(plan, record_events, chunks=chunks,
                      scenario_chunks=scenario_chunks)
    check_batch_shapes(values, budgets, rules)
    n_events, n_campaigns = values.shape
    if cap_times_init is None:
        cap_times_init = torch.full((n_campaigns,), never_capped(n_events),
                                    dtype=torch.int32)
    caps0 = torch.as_tensor(cap_times_init).to(values.device, torch.int32)
    caps0 = caps0.expand(budgets.shape[0], n_campaigns).contiguous()
    return refine_fixed_lanes(values, budgets, rules, caps0,
                              refine_iters=refine_iters,
                              record_events=record_events,
                              crossing_block=crossing_block)
