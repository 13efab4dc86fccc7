"""``ctypes`` wrapper of the scenario-batched resolve kernel
(``csrc/sweep_resolve.cu``), the port of ``repro``'s
``sweep_resolve_pallas``. It follows :mod:`repro_torch.kernels.binding`
and counts its launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"sweep_resolve": 0}

_SIGNATURES = {
    "sr_sweep_resolve": [_P] * 8 + [_I] * 7 + [_P],
    "sr_max_campaigns": [],
}


def reset_launches() -> None:
    LAUNCHES["sweep_resolve"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("sweep_resolve", _SIGNATURES)


def max_campaigns() -> int:
    """The largest C the kernel holds in shared memory; builds it."""
    return _lib().sr_max_campaigns()


def sweep_resolve_cuda(values: torch.Tensor, mult: torch.Tensor,
                       act: torch.Tensor, reserves: torch.Tensor, *,
                       second_price: bool, reduce_blocks: int):
    """Resolve S lanes against one (N, C) valuation matrix under an (S, C)
    or (S, N, C) activation. Returns ``(winners (S, N) int32, prices (S, N)
    float32, spend sums (S, C) float32)``; the sums are the in-order fold
    of event-ordered (S, reduce_blocks, C) block partials."""
    binding.require_cuda(values)
    lib = _lib()
    n, c = values.shape
    s = mult.shape[0]
    dev = values.device
    binding.check_campaigns(c, lib.sr_max_campaigns(), "sweep_resolve")
    per_event = act.ndim == 3
    ptrs = [
        _check("values", values, torch.float32, (n, c), dev),
        _check("multipliers", mult, torch.float32, (s, c), dev),
        _check("active", act, torch.bool, (s, n, c) if per_event else (s, c),
               dev),
        _check("reserves", reserves, torch.float32, (s,), dev),
    ]
    winners = torch.empty((s, n), dtype=torch.int32, device=dev)
    prices = torch.empty((s, n), dtype=torch.float32, device=dev)
    parts = torch.empty((s, reduce_blocks, c), dtype=torch.float32,
                        device=dev)
    sums = torch.empty((s, c), dtype=torch.float32, device=dev)
    err = lib.sr_sweep_resolve(
        *ptrs, winners.data_ptr(), prices.data_ptr(), parts.data_ptr(),
        sums.data_ptr(), s, n, c, -(-n // reduce_blocks), reduce_blocks,
        int(second_price), int(per_event), binding.stream(dev))
    binding.raise_on(err, "sweep_resolve_kernel")
    LAUNCHES["sweep_resolve"] += 1
    return winners, prices, sums
