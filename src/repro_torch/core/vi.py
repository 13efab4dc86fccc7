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
drawn at once (threefry is elementwise over keys); each batch is then one
``resolve_masked`` (the ``auction_resolve`` kernel on CUDA, padded rows
dead through ``live``) and a few (C,) updates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.floats import fma
from repro_torch.core.types import AuctionRule, never_capped
from repro_torch.kernels.auction_resolve import ops as resolve_ops

_OVERLAYS = ("overlay_row/overlay (intervention semantics in the VI) is not "
             "ported to repro_torch yet; see ROADMAP.md queue 1, item 5 (CRN "
             "scenario families)")


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


def _run(values, budgets, rule: AuctionRule, draws: _Draws, *,
         sample_size: int, batch_size: int, eta: float, eta_decay: float,
         pi0, track_every: int) -> PiEstimate:
    """The VI iteration of one design on given draws."""
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
    pi = torch.ones(n_campaigns, **f32) if pi0 is None \
        else pi0.to(**f32)
    second = rule.kind == "second_price"
    history = []
    for t in range(total):
        b = t % draws.n_batches
        lo = b * batch_size
        active = draws.u[t] < pi[None, :]                      # (B, C)
        _, _, sums = resolve_ops.resolve_masked(
            sampled[lo:lo + batch_size], rule.multipliers, active,
            rule.reserve, live[lo:lo + batch_size], second_price=second)
        delta = btilde - sums / denom[b]
        pi = torch.clamp(fma(step[t], delta, pi), 0.0, 1.0)
        if track_every:
            history.append(pi)
    hist = torch.stack(history)[::track_every] if track_every else None
    return PiEstimate(pi=pi, history=hist,
                      num_updates=torch.tensor(total, dtype=torch.int32))


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
    ``track_every`` records pi every that many batches."""
    if overlay_row is not None:
        raise NotImplementedError(_OVERLAYS)
    n_events, n_campaigns = values.shape
    draws = _draws(key, n_events, n_campaigns, sample_size=sample_size,
                   num_iters=num_iters, batch_size=batch_size,
                   coupling=coupling, device=values.device)
    return _run(values, budgets, rule, draws, sample_size=sample_size,
                batch_size=batch_size, eta=eta, eta_decay=eta_decay,
                pi0=pi0, track_every=track_every)


def estimate_pi_sweep(values: torch.Tensor, budgets: torch.Tensor,
                      rules: AuctionRule, key: torch.Tensor, *,
                      sample_size: int, num_iters: int = 20, eta: float = 0.5,
                      eta_decay: float = 0.0, batch_size: int = 1,
                      pi0: Optional[torch.Tensor] = None,
                      coupling: str = "shared", overlay=None) -> PiEstimate:
    """Algorithm 4 over a scenario batch (budgets (S, C), a stacked rule)
    with ONE key: every lane sees the same sampled events and the same
    uniforms (common random numbers), so pi deltas across scenarios are
    design effects. Lanes run one after another on the shared draws.
    Returns a :class:`PiEstimate` whose ``pi`` is (S, C)."""
    if overlay is not None:
        raise NotImplementedError(_OVERLAYS)
    n_events, n_campaigns = values.shape
    draws = _draws(key, n_events, n_campaigns, sample_size=sample_size,
                   num_iters=num_iters, batch_size=batch_size,
                   coupling=coupling, device=values.device)
    lanes = [
        _run(values, budgets[s], AuctionRule(
            multipliers=rules.multipliers[s], reserve=rules.reserve[s],
            kind=rules.kind), draws, sample_size=sample_size,
            batch_size=batch_size, eta=eta, eta_decay=eta_decay,
            pi0=None if pi0 is None else pi0[s], track_every=0)
        for s in range(budgets.shape[0])]
    return PiEstimate(pi=torch.stack([e.pi for e in lanes]), history=None,
                      num_updates=torch.stack([e.num_updates
                                               for e in lanes]))
