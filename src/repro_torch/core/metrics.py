"""Error metrics used in the paper's figures (port of
``repro.core.metrics``). A vector's sums are added in XLA CPU's order
(:func:`repro_torch.floats.xla_sum`), so the metrics are ``repro``'s bits
at any campaign count."""
from __future__ import annotations

import torch

from repro_torch.floats import xla_sum


def _sum(x: torch.Tensor) -> torch.Tensor:
    return xla_sum(x) if x.ndim == 1 else x.sum()


def relative_error(s_hat: torch.Tensor, s_ref: torch.Tensor,
                   c: int | None = None) -> torch.Tensor:
    """Fig. 1 metric: |s_hat - s| / s (for campaign |C| by default)."""
    if c is None:
        c = s_ref.shape[0] - 1
    denom = torch.clamp(s_ref[c].abs(), min=1e-12)
    return (s_hat[c] - s_ref[c]).abs() / denom


def _weighted_rel(s_hat: torch.Tensor, s_ref: torch.Tensor):
    rel = (s_hat - s_ref).abs() / torch.clamp(s_ref.abs(), min=1e-12)
    w = s_ref / torch.clamp(_sum(s_ref), min=1e-12)
    return rel, w


def spend_weighted_relative_error(s_hat: torch.Tensor,
                                  s_ref: torch.Tensor) -> torch.Tensor:
    """Fig. 6 metric: per-campaign relative errors weighted by reference
    spend."""
    rel, w = _weighted_rel(s_hat, s_ref)
    return _sum(rel * w)


def relative_error_cdf(s_hat: torch.Tensor, s_ref: torch.Tensor):
    """Spend-weighted cumulative distribution of per-campaign relative
    error (the Fig. 6 curve). Returns (sorted errors, cumulative weight)."""
    rel, w = _weighted_rel(s_hat, s_ref)
    order = torch.argsort(rel, stable=True)
    return rel[order], torch.cumsum(w[order], dim=0)


def cap_time_error(cap_hat: torch.Tensor, cap_ref: torch.Tensor,
                   n_events: int) -> torch.Tensor:
    """Mean |cap_hat - cap_ref| / N over campaigns that cap in either
    run."""
    caps = (cap_ref <= n_events) | (cap_hat <= n_events)
    err = (torch.clamp(cap_hat, max=n_events + 1).to(torch.float32)
           - torch.clamp(cap_ref, max=n_events + 1).to(torch.float32)).abs()
    return torch.where(caps, err, 0.0).sum() / torch.clamp(
        caps.sum(), min=1) / n_events
