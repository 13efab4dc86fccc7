"""``ctypes`` wrapper of the first-crossing kernel
(``csrc/first_crossing.cu``).

It replaces no Pallas kernel: on the TPU, XLA computes
``repro.core.segments.first_crossing_times`` (a blockwise ``jnp.cumsum``)
and ``auction.spend_sums`` (a segment sum). The kernel gives both in the
reference's float order; :mod:`repro_torch.core.segments` and
:mod:`repro_torch.core.auction` send CUDA tensors here, and keep the plain
versions (``first_crossing_ref``, ``index_add_``) for CPU tensors. The
wrapper follows :mod:`repro_torch.kernels.binding` and counts its launches
in :data:`LAUNCHES`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"first_crossing": 0}

_SIGNATURES = {"fc_first_crossing": [_P] * 5 + [_I] * 4 + [_P]}


def reset_launches() -> None:
    LAUNCHES["first_crossing"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("first_crossing", _SIGNATURES)


def first_crossing_cuda(winners: torch.Tensor, prices: torch.Tensor,
                        budgets: torch.Tensor | None, *, num_campaigns: int,
                        block: int = 4096):
    """S lanes of resolved events, winners (S, N) int32 and prices (S, N)
    float32. Returns ``(cap times (S, C) int32, spend (S, C) float32)``:
    the flat per-campaign sums in event order and, when ``budgets`` (S, C)
    is given, the first crossings of the blockwise running spend in XLA's
    cumsum order (None without budgets). One launch for all lanes."""
    binding.require_cuda(winners)
    lib = _lib()
    s, n = winners.shape
    c = num_campaigns
    dev = winners.device
    ptrs = [
        _check("winners", winners, torch.int32, (s, n), dev),
        _check("prices", prices, torch.float32, (s, n), dev),
        None if budgets is None else _check("budgets", budgets,
                                            torch.float32, (s, c), dev),
    ]
    if block < 1:
        raise ValueError(f"crossing block must be positive, got {block}")
    cap = None if budgets is None else torch.empty(
        (s, c), dtype=torch.int32, device=dev)
    spend = torch.empty((s, c), dtype=torch.float32, device=dev)
    err = lib.fc_first_crossing(
        *ptrs, None if cap is None else cap.data_ptr(), spend.data_ptr(), s,
        n, c, block, binding.stream(dev))
    binding.raise_on(err, "first_crossing_kernel")
    LAUNCHES["first_crossing"] += 1
    return cap, spend
