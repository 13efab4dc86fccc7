"""``ctypes`` wrapper of the capped-scan CUDA kernel
(``csrc/capped_scan.cu``), the port of ``repro``'s ``capped_scan_pallas``.
It follows :mod:`repro_torch.kernels.binding` and counts its launches in
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"capped_scan": 0}

_SIGNATURES = {
    "cs_capped_scan": [_P] * 9 + [_I] * 4 + [ctypes.c_float, _P],
    "cs_max_shared_campaigns": [],
}


def reset_launches() -> None:
    LAUNCHES["capped_scan"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("capped_scan", _SIGNATURES)


def capped_scan_cuda(values: torch.Tensor, budgets: torch.Tensor,
                     mult: torch.Tensor, reserves: torch.Tensor, *,
                     second_price: bool, scale: float = 1.0):
    """S exact replays in one launch, one CTA per lane, any C: the lane's
    state lives in shared memory up to ``cs_max_shared_campaigns()``
    campaigns and in device memory (a scratch buffer and the outputs)
    above. ``scale`` (a float32 > 0) multiplies each sale's spend
    increment (naive sampling's 1/rho); 1 is the exact replay. Returns
    ``(winners (S, N) int32, prices (S, N) float32, spend (S, C) float32,
    cap times (S, C) int32)``."""
    binding.require_cuda(values)
    lib = _lib()
    n, c = values.shape
    s = budgets.shape[0]
    dev = values.device
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
    scratch = None
    if c > lib.cs_max_shared_campaigns():
        scratch = torch.empty((s, c), dtype=torch.float32, device=dev)
    err = lib.cs_capped_scan(
        *ptrs, winners.data_ptr(), prices.data_ptr(), spend.data_ptr(),
        cap.data_ptr(), None if scratch is None else scratch.data_ptr(), s,
        n, c, int(second_price), float(scale), binding.stream(dev))
    binding.raise_on(err, "capped_scan_kernel")
    LAUNCHES["capped_scan"] += 1
    return winners, prices, spend, cap
