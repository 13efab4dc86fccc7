"""``ctypes`` wrapper of the event-ordered partials kernel
(``csrc/segment_partials.cu``).

It replaces no Pallas kernel: on the TPU, XLA's scatter-add computes
``repro.core.segments.partial_spend_sums``. On CUDA, ``index_add_`` adds
with atomics in an order that changes from run to run, so
:mod:`repro_torch.core.segments` sends CUDA tensors here and keeps
``index_add_`` (event order on the CPU) as the plain version. The wrapper
follows :mod:`repro_torch.kernels.binding` and counts its launches in
:data:`LAUNCHES`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"segment_partials": 0}

_SIGNATURES = {
    "sp_segment_partials": [_P] * 5 + [_I] * 6 + [_P],
    "sp_max_campaigns": [],
}


def reset_launches() -> None:
    LAUNCHES["segment_partials"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("segment_partials", _SIGNATURES)


def segment_partials_cuda(winners: torch.Tensor, prices: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor, *,
                          num_campaigns: int, block_size: int,
                          reduce_blocks: int, offset: int = 0
                          ) -> torch.Tensor:
    """(S, G, C) canonical partials of resolved events, added in event
    order: ``winners``/``prices`` (S, n) are global events ``[offset,
    offset + n)``, and lane s adds those inside its window ``[lo[s],
    hi[s])``. One launch for all S lanes."""
    binding.require_cuda(winners)
    lib = _lib()
    s, n = winners.shape
    dev = winners.device
    binding.check_campaigns(num_campaigns, lib.sp_max_campaigns(),
                            "segment_partials")
    ptrs = [
        _check("winners", winners, torch.int32, (s, n), dev),
        _check("prices", prices, torch.float32, (s, n), dev),
        _check("lo", lo, torch.int32, (s,), dev),
        _check("hi", hi, torch.int32, (s,), dev),
    ]
    parts = torch.empty((s, reduce_blocks, num_campaigns),
                        dtype=torch.float32, device=dev)
    err = lib.sp_segment_partials(
        *ptrs, parts.data_ptr(), s, n, num_campaigns, int(offset),
        block_size, reduce_blocks, binding.stream(dev))
    binding.raise_on(err, "segment_partials_kernel")
    LAUNCHES["segment_partials"] += 1
    return parts
