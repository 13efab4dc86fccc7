"""Algorithm 4 — cap-out time estimation by *uncertainty relaxation* (port
of ``repro.core.vi``).

The binary activation vector is relaxed to a probability vector
``pi in [0,1]^C``; ``pi_c`` is the scaled cap-out time ``N_c / N``. At every
sampled event the algorithm draws a Bernoulli activation ``a_c = 1{u < pi_c}``,
resolves the auction and nudges ``pi`` along the budget residual:

    pi  <-  clip( pi + eta * B * (b/N - mean f(e, a)), 0, 1 )

over minibatches of B sampled events (``batch_size=1`` is the paper's
pseudocode).

The random draws are ``repro``'s: the sample is ``choice(replace=False)``
of a split of the key and the activations' uniforms come from
``split(k_events, total_batches)``, all through :mod:`repro_torch.prng`, so
the same key gives the same estimate bit for bit. All uniforms of a run are
drawn at once (threefry is elementwise over keys). On the CPU each batch is
then one ``resolve_masked`` (padded rows dead through ``live``) and a few
(C,) updates, a loop on the host: the plain version. On CUDA every batch of
every lane is one launch of the ``vi`` kernel (``csrc/vi.cu``), which
gives the loop's bits.

A scenario overlay (``overlay_row`` of one design, ``overlay`` of a sweep;
:class:`~repro_torch.core.types.ScenarioOverlay`) makes the estimate see
the scenario's random world, as in ``repro``: each lane's sampled rows
perturbed by the ``"bid_noise"`` CRN stream at the sampled events' global
indices, and a per-lane eligibility (live windows on those indices, the
``"participation"`` stream) ANDed into every activation. The draws are
the executor's (:mod:`repro_torch.core.crn`), made on the values' device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.floats import fma
from repro_torch.core import crn
from repro_torch.core.types import AuctionRule, ScenarioOverlay, never_capped
from repro_torch.kernels import crn as crn_ops
from repro_torch.kernels.auction_resolve import ops as resolve_ops
from repro_torch.kernels.auction_resolve.vi import vi_cuda


@dataclasses.dataclass(frozen=True)
class PiEstimate:
    pi: torch.Tensor                       # (C,) in [0, 1], or (S, C)
    history: Optional[torch.Tensor]        # (n_tracked, C) or None
    num_updates: torch.Tensor              # () int32


def pi_to_cap_times(pi: torch.Tensor, n_events: int,
                    tol: float = 1e-3) -> torch.Tensor:
    """pi -> 1-based cap times (int32); pi within ``tol`` of 1 means
    "never caps". Rounds half to even, as ``jnp.round``."""
    caps = torch.round(pi * torch.tensor(float(n_events), dtype=pi.dtype,
                                          device=pi.device))
    caps = torch.clamp(caps.to(torch.int32), 1, n_events)
    never = pi >= torch.tensor(1.0 - tol, dtype=pi.dtype, device=pi.device)
    return torch.where(never, never_capped(n_events), caps).to(torch.int32)


def capping_order(pi: torch.Tensor, tol: float = 1e-3):
    """(order, caps_mask): campaigns sorted by estimated cap time (stable);
    mask of campaigns predicted to cap at all."""
    caps = pi < torch.tensor(1.0 - tol, dtype=pi.dtype, device=pi.device)
    order = torch.argsort(torch.where(caps, pi, float("inf")), stable=True)
    return order, caps


@dataclasses.dataclass(frozen=True)
class _Draws:
    """Everything random in one run, shared by every scenario lane."""
    idx: torch.Tensor          # (k,) sampled events
    u: torch.Tensor            # (total_batches, B, 1 or C) uniforms
    n_batches: int


def _draws(key: torch.Tensor, n_events: int, n_campaigns: int, *,
           sample_size: int, num_iters: int, batch_size: int, coupling: str,
           device) -> _Draws:
    if coupling not in ("shared", "independent"):
        raise ValueError(f"unknown coupling: {coupling}")
    key = key.to(device)
    k_sample, k_events = prng.split(key)
    idx = prng.choice(k_sample, n_events, sample_size)
    n_batches = -(-sample_size // batch_size)
    keys = prng.split(k_events, num_iters * n_batches)
    width = 1 if coupling == "shared" else n_campaigns
    return _Draws(idx=idx, u=prng.uniform(keys, (batch_size, width)),
                  n_batches=n_batches)


@dataclasses.dataclass(frozen=True)
class _Chain:
    """What every batch step reads besides pi: the sampled rows (padded to
    whole batches with dead zero rows; with an overlay's bid noise, a set
    a lane), the live rows, each batch's live count, the per-event
    budgets, each step's size and an overlay's eligibility."""
    sampled: torch.Tensor      # ([S,] n_batches * B, C)
    live: torch.Tensor         # (n_batches * B,) bool
    denom: torch.Tensor        # (n_batches,) float32, at least 1
    btilde: torch.Tensor       # (..., C) budgets / N
    step: torch.Tensor         # (total,) float32
    elig: Optional[torch.Tensor] = None   # ([S,] n_batches * B, C) bool

    def lane(self, s: int) -> "_Chain":
        """Lane ``s``'s chain of a chain built for several lanes."""
        return dataclasses.replace(
            self, btilde=self.btilde[s],
            sampled=self.sampled[s] if self.sampled.ndim == 3
            else self.sampled,
            elig=None if self.elig is None else self.elig[s])


def _overlay_inputs(values, draws: _Draws, overlay: ScenarioOverlay, *,
                    rows: int):
    """(S, rows, C) perturbed sampled rows (None without bid noise) and
    (S, rows, C) eligibility (None without windows or participation) of
    the (S, C) overlay at the sampled events; padded rows zero and
    ineligible, as ``jnp.pad`` pads them."""
    if (overlay.bid_sigma is not None or overlay.part_prob is not None) \
            and overlay.key is None:
        raise ValueError(
            "overlay_row carries stochastic fields but no CRN key")
    dev = values.device
    ol = overlay.map_fields(lambda x: x.to(dev))
    n_campaigns = values.shape[1]
    idx = draws.idx
    k = idx.shape[0]
    s = ol.num_scenarios
    sampled = elig = None
    if ol.bid_sigma is not None:
        z = crn.event_campaign_normals(crn.stream_key(ol.key, "bid_noise"),
                                       idx, n_campaigns)
        sampled = torch.zeros((s, rows, n_campaigns), dtype=torch.float32,
                              device=dev)
        sampled[:, :k] = crn_ops.bid_noise(values[idx], z, ol.bid_sigma)
    if ol.live_start is not None or ol.part_prob is not None:
        elig = torch.zeros((s, rows, n_campaigns), dtype=torch.bool,
                           device=dev)
        e = torch.ones((s, k, n_campaigns), dtype=torch.bool, device=dev)
        if ol.live_start is not None:
            gi = idx.to(torch.int32)[None, :, None]
            e = e & (gi >= ol.live_start[:, None, :]) \
                & (gi < ol.live_stop[:, None, :])
        if ol.part_prob is not None:
            u_p = crn.event_campaign_uniforms(
                crn.stream_key(ol.key, "participation"), idx, n_campaigns)
            e = e & (u_p[None] < ol.part_prob[:, None, :])
        elig[:, :k] = e
    return sampled, elig


def _chain(values, budgets, draws: _Draws, *, sample_size: int,
           batch_size: int, eta: float, eta_decay: float,
           overlay: Optional[ScenarioOverlay] = None) -> _Chain:
    n_events, n_campaigns = values.shape
    dev = values.device
    f32 = dict(dtype=torch.float32, device=dev)
    rows = draws.n_batches * batch_size
    sampled = torch.zeros((rows, n_campaigns), **f32)
    sampled[:sample_size] = values[draws.idx]
    live = torch.arange(rows, device=dev) < sample_size
    denom = torch.clamp(live.reshape(-1, batch_size).to(torch.float32)
                        .sum(-1), min=1.0)                    # (n_batches,)
    btilde = budgets.to(torch.float32) / torch.tensor(float(n_events), **f32)
    total = draws.u.shape[0]
    epoch = (torch.arange(total, device=dev) // draws.n_batches).to(
        torch.float32)
    # XLA fuses both the step's and the update's multiply-add (one rounding)
    eta_t = torch.tensor(eta, **f32) / fma(
        torch.tensor(eta_decay, **f32), epoch, torch.ones((), **f32))
    step = eta_t * torch.tensor(float(batch_size), **f32)      # (total,)
    elig = None
    if overlay is not None:
        noisy, elig = _overlay_inputs(values, draws, overlay, rows=rows)
        if noisy is not None:
            sampled = noisy
    return _Chain(sampled=sampled, live=live, denom=denom, btilde=btilde,
                  step=step, elig=elig)


def _run_cuda(chain: _Chain, rules: AuctionRule, draws: _Draws, pi0, *,
              sample_size: int, track_every: int):
    """Every batch of S lanes (``chain.btilde`` and the rule's fields (S,
    ...)) in one ``vi`` kernel launch. Returns ``(pi (S, C), history (S,
    n_tracked, C) or None)``."""
    s, c = chain.btilde.shape
    dev = chain.sampled.device
    pi = torch.ones((s, c), dtype=torch.float32, device=dev) \
        if pi0 is None else pi0.to(device=dev, dtype=torch.float32)
    return vi_cuda(
        chain.sampled.contiguous(), draws.u.contiguous(),
        chain.step.contiguous(), chain.denom.contiguous(),
        chain.btilde.contiguous(),
        rules.multipliers.to(device=dev, dtype=torch.float32).contiguous(),
        torch.as_tensor(rules.reserve, dtype=torch.float32,
                        device=dev).reshape(s).contiguous(), pi,
        sample_size=sample_size, second_price=rules.kind == "second_price",
        track_every=track_every,
        elig=None if chain.elig is None else chain.elig.contiguous())


def _run(values, budgets, rule: AuctionRule, draws: _Draws, *,
         sample_size: int, batch_size: int, eta: float, eta_decay: float,
         pi0, track_every: int) -> PiEstimate:
    """The VI iteration of one design on given draws, without an
    overlay."""
    chain = _chain(values, budgets, draws, sample_size=sample_size,
                   batch_size=batch_size, eta=eta, eta_decay=eta_decay)
    return _iterate(chain, rule, draws, sample_size=sample_size,
                    batch_size=batch_size, pi0=pi0, track_every=track_every)


def _iterate(chain: _Chain, rule: AuctionRule, draws: _Draws, *,
             sample_size: int, batch_size: int, pi0,
             track_every: int) -> PiEstimate:
    """The VI iteration of one design on given draws and chain: one ``vi``
    launch on CUDA, the host loop (the plain version) on the CPU."""
    n_campaigns = chain.btilde.shape[-1]
    dev = chain.step.device
    total = draws.u.shape[0]
    updates = torch.tensor(total, dtype=torch.int32)
    if dev.type == "cuda":
        lane = AuctionRule(multipliers=rule.multipliers.reshape(1, -1),
                           reserve=torch.as_tensor(rule.reserve).reshape(1),
                           kind=rule.kind)
        pi, hist = _run_cuda(
            dataclasses.replace(
                chain, btilde=chain.btilde.reshape(1, -1),
                elig=None if chain.elig is None else chain.elig[None]),
            lane, draws, None if pi0 is None else pi0.reshape(1, -1),
            sample_size=sample_size, track_every=track_every)
        return PiEstimate(pi=pi[0], history=None if hist is None
                          else hist[0], num_updates=updates)
    pi = torch.ones(n_campaigns, dtype=torch.float32, device=dev) \
        if pi0 is None else pi0.to(dtype=torch.float32, device=dev)
    second = rule.kind == "second_price"
    history = []
    for t in range(total):
        b = t % draws.n_batches
        lo = b * batch_size
        active = draws.u[t] < pi[None, :]                      # (B, C)
        if chain.elig is not None:
            active = active & chain.elig[lo:lo + batch_size]
        _, _, sums = resolve_ops.resolve_masked(
            chain.sampled[lo:lo + batch_size], rule.multipliers, active,
            rule.reserve, chain.live[lo:lo + batch_size],
            second_price=second)
        delta = chain.btilde - sums / chain.denom[b]
        pi = torch.clamp(fma(chain.step[t], delta, pi), 0.0, 1.0)
        if track_every:
            history.append(pi)
    hist = torch.stack(history)[::track_every] if track_every else None
    return PiEstimate(pi=pi, history=hist, num_updates=updates)


def estimate_pi(values: torch.Tensor, budgets: torch.Tensor,
                rule: AuctionRule, key: torch.Tensor, *, sample_size: int,
                num_iters: int = 20, eta: float = 0.5,
                eta_decay: float = 0.0, batch_size: int = 1,
                pi0: Optional[torch.Tensor] = None, track_every: int = 0,
                coupling: str = "shared",
                overlay_row=None) -> PiEstimate:
    """Algorithm 4 for one design: ``sample_size`` events sampled without
    replacement by ``key`` (a :mod:`repro_torch.prng` key), ``num_iters``
    epochs of minibatches of ``batch_size`` events, step ``eta / (1 +
    eta_decay * epoch)``. ``coupling="shared"`` draws one uniform per event
    (``a_c = 1{u < pi_c}``), ``"independent"`` one per (event, campaign).
    ``track_every`` records pi every that many batches. ``overlay_row``
    (a :class:`~repro_torch.core.types.ScenarioOverlay` with (C,) fields)
    estimates pi under one scenario's intervention semantics (the module
    docstring)."""
    n_events, n_campaigns = values.shape
    draws = _draws(key, n_events, n_campaigns, sample_size=sample_size,
                   num_iters=num_iters, batch_size=batch_size,
                   coupling=coupling, device=values.device)
    overlay = None if overlay_row is None else \
        overlay_row.map_fields(lambda x: x[None])
    chain = _chain(values, budgets, draws, sample_size=sample_size,
                   batch_size=batch_size, eta=eta, eta_decay=eta_decay,
                   overlay=overlay)
    if overlay is not None:
        chain = dataclasses.replace(chain.lane(0), btilde=chain.btilde)
    return _iterate(chain, rule, draws, sample_size=sample_size,
                batch_size=batch_size, pi0=pi0, track_every=track_every)


def estimate_pi_sweep(values: torch.Tensor, budgets: torch.Tensor,
                      rules: AuctionRule, key: torch.Tensor, *,
                      sample_size: int, num_iters: int = 20, eta: float = 0.5,
                      eta_decay: float = 0.0, batch_size: int = 1,
                      pi0: Optional[torch.Tensor] = None,
                      coupling: str = "shared", overlay=None) -> PiEstimate:
    """Algorithm 4 over a scenario batch (budgets (S, C), a stacked rule)
    with ONE key: every lane sees the same sampled events and the same
    uniforms (common random numbers), so pi deltas across scenarios are
    design effects. ``overlay`` (a scenario-batched
    :class:`~repro_torch.core.types.ScenarioOverlay`) estimates each lane
    under its intervention semantics, on the same CRN draws. On CUDA every
    lane runs in one ``vi`` kernel launch (each lane's perturbed rows and
    eligibility with it); on the CPU the lanes run one after another on
    the shared draws. Returns a :class:`PiEstimate` whose ``pi`` is (S,
    C)."""
    n_events, n_campaigns = values.shape
    draws = _draws(key, n_events, n_campaigns, sample_size=sample_size,
                   num_iters=num_iters, batch_size=batch_size,
                   coupling=coupling, device=values.device)
    chain = _chain(values, budgets, draws, sample_size=sample_size,
                   batch_size=batch_size, eta=eta, eta_decay=eta_decay,
                   overlay=overlay)
    if values.device.type == "cuda":
        pi, _ = _run_cuda(chain, rules, draws, pi0, sample_size=sample_size,
                          track_every=0)
        return PiEstimate(pi=pi, history=None, num_updates=torch.full(
            (budgets.shape[0],), draws.u.shape[0], dtype=torch.int32))
    lanes = [
        _iterate(chain.lane(s), AuctionRule(
            multipliers=rules.multipliers[s], reserve=rules.reserve[s],
            kind=rules.kind), draws, sample_size=sample_size,
            batch_size=batch_size, pi0=None if pi0 is None else pi0[s],
            track_every=0)
        for s in range(budgets.shape[0])]
    return PiEstimate(pi=torch.stack([e.pi for e in lanes]), history=None,
                      num_updates=torch.stack([e.num_updates
                                               for e in lanes]))
