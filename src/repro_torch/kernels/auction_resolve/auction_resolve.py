"""``ctypes`` wrapper of the single-design resolve kernel
(``csrc/auction_resolve.cu``), the port of ``repro``'s
``auction_resolve_pallas``. Two tile sources: valuations computed from
embeddings (:func:`resolve_emb_cuda`) or read from a valuation matrix
(:func:`resolve_matrix_cuda`). It follows
:mod:`repro_torch.kernels.binding` and counts its launches in
:data:`LAUNCHES`. The kernel returns winners and prices; :mod:`.ops` adds
the spend sums with ``first_crossing``'s flat sum.

The kernel's shared memory holds EmbTile's embeddings of at most
:func:`emb_max_campaigns` campaigns; the wrapper refuses more, and
:mod:`.ops` resolves such calls in campaign chunks.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"auction_resolve": 0}

ROWS_PER_CTA = 128          # kRows of the kernel: EmbTile stages 128*d floats

_SIGNATURES = {
    "ar_resolve_matrix": [_P] * 7 + [_I] * 4 + [_P],
    "ar_resolve_emb": [_P, _P, _I, _I, ctypes.c_float] + [_P] * 6
    + [_I] * 4 + [_P],
    "ar_max_shared_floats": [],
}


def reset_launches() -> None:
    LAUNCHES["auction_resolve"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("auction_resolve", _SIGNATURES)


def max_shared_floats() -> int:
    """Floats of shared memory the kernel has for EmbTile's embeddings;
    builds the kernel."""
    return _lib().ar_max_shared_floats()


def emb_max_campaigns(d: int) -> int:
    """The largest C whose EmbTile embeddings, C·d + 128·d floats, fit."""
    return max_shared_floats() // d - ROWS_PER_CTA


def _lane_ptrs(mult, act, live, reserve, n, c, dev):
    per_event = act.ndim == 2
    ptrs = [
        _check("multipliers", mult, torch.float32, (c,), dev),
        _check("active", act, torch.bool, (n, c) if per_event else (c,), dev),
        None if live is None else _check("live", live, torch.bool, (n,), dev),
        _check("reserve", reserve, torch.float32, (), dev),
    ]
    return ptrs, per_event


def _outputs(n, dev):
    return (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev))


def resolve_matrix_cuda(values: torch.Tensor, mult: torch.Tensor,
                        act: torch.Tensor, live: torch.Tensor | None,
                        reserve: torch.Tensor, *, second_price: bool):
    """Resolve the N events of a valuation matrix (N, C) under a (C,) or
    (N, C) activation and optional live rows (N,). Returns ``(winners (N,)
    int32, prices (N,) float32)``."""
    binding.require_cuda(values)
    lib = _lib()
    n, c = values.shape
    dev = values.device
    ptrs, per_event = _lane_ptrs(mult, act, live, reserve, n, c, dev)
    v_ptr = _check("values", values, torch.float32, (n, c), dev)
    winners, prices = _outputs(n, dev)
    err = lib.ar_resolve_matrix(
        v_ptr, *ptrs, winners.data_ptr(), prices.data_ptr(), n, c,
        int(per_event), int(second_price), binding.stream(dev))
    binding.raise_on(err, "auction_resolve_kernel")
    LAUNCHES["auction_resolve"] += 1
    return winners, prices


def resolve_emb_cuda(event_emb: torch.Tensor, campaign_emb: torch.Tensor,
                     mult: torch.Tensor, act: torch.Tensor,
                     live: torch.Tensor | None, reserve: torch.Tensor, *,
                     second_price: bool):
    """Resolve N events whose valuations are Eq. 12 of event embeddings
    (N, d) and campaign embeddings (C, d), both float32 or both bf16.
    Returns ``(winners (N,) int32, prices (N,) float32)``."""
    binding.require_cuda(event_emb)
    lib = _lib()
    n, d = event_emb.shape
    c = campaign_emb.shape[0]
    dev = event_emb.device
    dtype = event_emb.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"embeddings have dtype {dtype}, expected float32 "
                         "or bfloat16")
    binding.check_campaigns(c, emb_max_campaigns(d),
                            f"auction_resolve EmbTile (d={d})")
    ptrs, per_event = _lane_ptrs(mult, act, live, reserve, n, c, dev)
    winners, prices = _outputs(n, dev)
    err = lib.ar_resolve_emb(
        _check("event_emb", event_emb, dtype, (n, d), dev),
        _check("campaign_emb", campaign_emb, dtype, (c, d), dev),
        int(dtype == torch.bfloat16), d, inv_scale(d), *ptrs,
        winners.data_ptr(), prices.data_ptr(), n, c, int(per_event),
        int(second_price), binding.stream(dev))
    binding.raise_on(err, "auction_resolve_kernel")
    LAUNCHES["auction_resolve"] += 1
    return winners, prices


def inv_scale(d: int) -> float:
    """Eq. 12's logit scale ``1 / (2 sqrt d)``, the float the TPU kernel
    multiplies by (rounded to float32 where it is used)."""
    return 1.0 / (2.0 * math.sqrt(d))
