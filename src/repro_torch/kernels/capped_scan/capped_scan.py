"""``ctypes`` wrapper of the capped-scan CUDA kernel
(``csrc/capped_scan.cu``), the port of ``repro``'s ``capped_scan_pallas``.
It follows :mod:`repro_torch.kernels.binding` and counts its launches in
:data:`LAUNCHES`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"capped_scan": 0}

_SIGNATURES = {
    "cs_capped_scan": [_P] * 8 + [_I] * 4 + [_P],
    "cs_max_campaigns": [],
}


def reset_launches() -> None:
    LAUNCHES["capped_scan"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("capped_scan", _SIGNATURES)


def capped_scan_cuda(values: torch.Tensor, budgets: torch.Tensor,
                     mult: torch.Tensor, reserves: torch.Tensor, *,
                     second_price: bool):
    """S exact replays in one launch, one warp per lane. Returns
    ``(winners (S, N) int32, prices (S, N) float32, spend (S, C) float32,
    cap times (S, C) int32)``."""
    binding.require_cuda(values)
    lib = _lib()
    n, c = values.shape
    s = budgets.shape[0]
    dev = values.device
    binding.check_campaigns(c, lib.cs_max_campaigns(), "capped_scan")
    ptrs = [
        _check("values", values, torch.float32, (n, c), dev),
        _check("budgets", budgets, torch.float32, (s, c), dev),
        _check("multipliers", mult, torch.float32, (s, c), dev),
        _check("reserves", reserves, torch.float32, (s,), dev),
    ]
    winners = torch.empty((s, n), dtype=torch.int32, device=dev)
    prices = torch.empty((s, n), dtype=torch.float32, device=dev)
    spend = torch.empty((s, c), dtype=torch.float32, device=dev)
    cap = torch.empty((s, c), dtype=torch.int32, device=dev)
    err = lib.cs_capped_scan(
        *ptrs, winners.data_ptr(), prices.data_ptr(), spend.data_ptr(),
        cap.data_ptr(), s, n, c, int(second_price), binding.stream(dev))
    binding.raise_on(err, "capped_scan_kernel")
    LAUNCHES["capped_scan"] += 1
    return winners, prices, spend, cap
