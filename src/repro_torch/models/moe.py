"""Mixture-of-Experts MLP (port of ``repro.models.moe``): GShard capacity
dispatch in groups.

The (B·S) tokens, padded to whole groups of ``moe_group_size``, are
routed group by group: a float32 softmax over the experts, the top k
experts of each token, and one slot per (token, choice) in its expert's
buffer of ``capacity`` slots, counted in token order with a token's
choices nested. A choice past its expert's capacity is dropped. Dispatch
and combine are dense one-hot tensors in the activations' dtype, as the
reference builds them; the products are plain ``torch`` products, as
the reference leaves them to XLA.

Routing is an integer result and is the reference's exactly:

* ``jax.lax.top_k`` breaks a tie by the lower expert index; ``torch.topk``
  does not, so the top k come from a stable descending sort;
* the slots are an exclusive cumulative count of the one-hot choices; the
  counts are small integers, so an integer cumsum gives the reference's
  float32 one bit for bit.

Routing is also a discontinuous function of the router's input: where two
experts' probabilities lie within a last-bit drift of each other (a near
tie), two runs whose matmuls add in other orders can choose differently.
:func:`record_routing` keeps one run's choices, and
:func:`follow_routing` makes another run take them at such near ties
(and only there), so that two devices or two packages can be compared
past one.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import COMPUTE_DTYPE, cdt, silu
from repro_torch.models.spec import new_param


class MoE(nn.Module):
    """``router`` (d, e), ``wi_gate`` and ``wi_up`` (e, d, f), ``wo``
    (e, f, d): the reference's layouts, in bfloat16 (its ``cdt``)."""
    LOGICAL = {"router": ("embed", "expert"),
               "wi_gate": ("expert", "embed", "ff"),
               "wi_up": ("expert", "embed", "ff"),
               "wo": ("expert", "ff", "embed")}

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = new_param((d, e), COMPUTE_DTYPE, device)
        self.wi_gate = new_param((e, d, f), COMPUTE_DTYPE, device)
        self.wi_up = new_param((e, d, f), COMPUTE_DTYPE, device)
        self.wo = new_param((e, f, d), COMPUTE_DTYPE, device)


class Routing(NamedTuple):
    """One routing of (g groups, t tokens a group), e experts, k choices."""
    probs: torch.Tensor      # (g, t, e) float32 softmax
    gates: torch.Tensor      # (g, t, k) float32, normalised over the k
    experts: torch.Tensor    # (g, t, k) int64, best first
    slots: torch.Tensor      # (g, t, k) int64 buffer position (before cap)
    valid: torch.Tensor      # (g, t) float32: 1 for a token, 0 for padding
    dispatch: torch.Tensor   # (g, t, e, cap) x.dtype one-hot
    combine: torch.Tensor    # (g, t, e, cap) x.dtype gate weights


def capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    cap = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
              / cfg.n_experts)
    return max(cap, cfg.top_k)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


_HOOKS: list = []     # record_routing / follow_routing, innermost last


def _choose(probs: torch.Tensor, k: int):
    vals, idx = top_k(probs, k)
    for hook in _HOOKS:
        vals, idx = hook(probs, vals, idx)
    return vals, idx


@contextlib.contextmanager
def record_routing(log: list) -> Iterator[list]:
    """Append every MoE call's ``(probs (g, t, e) float32, experts (g, t,
    k))``, on the CPU, to ``log`` while the context is open."""
    def hook(probs, vals, idx):
        log.append((probs.detach().float().cpu(), idx.cpu()))
        return vals, idx
    _HOOKS.append(hook)
    try:
        yield log
    finally:
        _HOOKS.remove(hook)


class RoutingMismatch(ValueError):
    """A choice differs from the followed run's at a token whose
    probabilities drift more than allowed: not a near tie."""


@contextlib.contextmanager
def follow_routing(log, max_drift: float) -> Iterator[List[dict]]:
    """Take the experts of ``log`` (``(probs, experts)`` a call, in call
    order, as :func:`record_routing` keeps them; tensors or arrays) where
    this run's choice differs from them at a token whose probabilities are
    within ``max_drift`` of ``log``'s; raise :class:`RoutingMismatch`
    where they drift more. Yields the list of near ties taken, each a
    dict of ``call``, ``group``, ``token``, ``own`` and ``followed``
    experts and ``drift``; after the context, every call of ``log`` must
    have been made."""
    calls = iter(enumerate(log))
    ties: List[dict] = []

    def hook(probs, vals, idx):
        call, (ref_probs, ref_idx) = next(calls)
        ref_probs = torch.as_tensor(ref_probs).to(probs.device, torch.float32)
        ref_idx = torch.as_tensor(ref_idx).to(idx.device, idx.dtype)
        differ = (idx != ref_idx).any(-1)
        if not bool(differ.any()):
            return vals, idx
        drift = (probs.detach() - ref_probs).abs().amax(-1)
        for g, t in torch.nonzero(differ).tolist():
            tie = dict(call=call, group=g, token=t, own=idx[g, t].tolist(),
                       followed=ref_idx[g, t].tolist(),
                       drift=float(drift[g, t]))
            if tie["drift"] > max_drift:
                raise RoutingMismatch(
                    f"MoE call {call}, group {g}, token {t}: experts "
                    f"{tie['own']}, the followed run's {tie['followed']}, "
                    f"probabilities {tie['drift']:.4g} apart (> "
                    f"{max_drift})")
            ties.append(tie)
        return torch.gather(probs, -1, ref_idx), ref_idx

    _HOOKS.append(hook)
    try:
        yield ties
    finally:
        _HOOKS.remove(hook)
    left = next(calls, None)
    if left is not None:
        raise RoutingMismatch(f"the followed run made more MoE calls: call "
                              f"{left[0]} was not made")


def groups(x: torch.Tensor, cfg: ArchConfig):
    """``x`` (B, S, d) as ``(xg (g, t, d), valid (g, t) float32)``: the
    flattened rows padded with zeros to whole groups of ``t =
    min(moe_group_size, B*S)``."""
    b, s, d = x.shape
    n = b * s
    g_size = min(cfg.moe_group_size, n)
    pad = (-n) % g_size
    xg = F.pad(x.reshape(n, d), (0, 0, 0, pad)).reshape(-1, g_size, d)
    valid = F.pad(torch.ones(n, dtype=torch.float32, device=x.device),
                  (0, pad)).reshape(-1, g_size)
    return xg, valid


def route(p: MoE, x: torch.Tensor, cfg: ArchConfig) -> Routing:
    """The routing of ``x`` (B, S, d), grouped over the flattened rows."""
    xg, valid = groups(x, cfg)
    g_size = xg.shape[1]
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(g_size, cfg)
    logits = (xg @ cdt(p.router, x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, experts = _choose(probs, k)
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                    min=1e-9)
    # (g, t, k, e) one-hot of the choices; padded rows choose nothing
    sel = F.one_hot(experts, e) * (valid[..., None, None] > 0)
    flat = sel.reshape(sel.shape[0], g_size * k, e)
    before = torch.cumsum(flat, dim=1) - flat                  # exclusive
    slots = (before * flat).sum(-1).reshape(-1, g_size, k)
    slot_oh = (F.one_hot(torch.where(slots < cap, slots, 0), cap)
               * (slots < cap)[..., None]).to(x.dtype)          # (g,t,k,cap)
    # one nonzero term an output: exact in any accumulation
    dispatch = torch.einsum("gtke,gtkc->gtec", sel.to(x.dtype), slot_oh)
    combine = torch.einsum("gtke,gtkc->gtec",
                           (sel * gates[..., None]).to(x.dtype), slot_oh)
    return Routing(probs, gates, experts, slots, valid, dispatch, combine)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> ``(out (B, S, d), aux ())``: the routed experts'
    SwiGLU outputs weighted by their gates, and the Switch/GShard
    load-balancing loss (float32). Out of place throughout, so autograd
    takes the gradient of both (``aux`` through the router's
    probabilities, as in the reference)."""
    b, s, d = x.shape
    r = route(p, x, cfg)
    xg, _ = groups(x, cfg)
    # every (expert, slot) holds at most one token: this product gathers,
    # exact in any accumulation
    expert_in = torch.einsum("gtec,gtd->egcd", r.dispatch, xg)
    e, g, cap, _ = expert_in.shape
    rows = expert_in.reshape(e, g * cap, d)
    gate = rows @ cdt(p.wi_gate, rows.dtype)
    up = rows @ cdt(p.wi_up, rows.dtype)
    expert_out = ((silu(gate) * up) @ cdt(p.wo, rows.dtype)).reshape(
        e, g, cap, d)
    out = torch.einsum("gtec,egcd->gtd", r.combine, expert_out)
    out = out.reshape(-1, d)[: b * s]

    sel = F.one_hot(r.experts, cfg.n_experts).float() \
        * r.valid[..., None, None]
    frac = sel[..., 0, :] if cfg.top_k == 1 else sel.sum(2).clamp(0, 1)
    denom = torch.clamp(r.valid.sum(), min=1.0)
    frac = frac.sum(dim=(0, 1)) / denom
    mean_prob = (r.probs * r.valid[..., None]).sum(dim=(0, 1)) / denom
    aux = (frac * mean_prob).sum() * cfg.n_experts
    return out.reshape(b, s, d), aux
