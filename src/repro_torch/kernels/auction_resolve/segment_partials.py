"""``ctypes`` wrapper of the event-ordered partials kernel
(``csrc/segment_partials.cu``).

It replaces no Pallas kernel: on the TPU, XLA's scatter-add computes
``repro.core.segments.partial_spend_sums``. On CUDA, ``index_add_`` adds
with atomics in an order that changes from run to run, so
:mod:`repro_torch.core.segments` sends CUDA tensors here and keeps
``index_add_`` (event order on the CPU) as the plain version. The wrapper
follows :mod:`repro_torch.kernels.binding` and counts its launches in
:data:`LAUNCHES`; ``"segment_partials_chunked"`` counts the calls whose C
was above the kernel's shared memory and ran in campaign chunks.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"segment_partials": 0, "segment_partials_chunked": 0}

_SIGNATURES = {
    "sp_segment_partials": [_P] * 5 + [_I] * 6 + [_P],
    "sp_max_campaigns": [],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("segment_partials", _SIGNATURES)


def by_campaign_chunks(partials, winners: torch.Tensor, num_campaigns: int,
                       chunk: int) -> torch.Tensor:
    """Per-campaign partials of C campaigns from ``partials(w, c)``, which
    takes at most ``chunk`` campaigns: chunk [c0, c1) sees the winners
    ``w - c0`` inside it and -1 (no sale) elsewhere, and its (..., c1 - c0)
    result fills those columns. Each campaign's partial is an ordered sum of
    its own prices, so a chunk alone gives the same bits."""
    out = []
    for c0 in range(0, num_campaigns, chunk):
        c1 = min(c0 + chunk, num_campaigns)
        inside = (winners >= c0) & (winners < c1)
        out.append(partials(torch.where(inside, winners - c0, -1)
                            .to(winners.dtype).contiguous(), c1 - c0))
    return torch.cat(out, dim=-1)


def segment_partials_cuda(winners: torch.Tensor, prices: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor, *,
                          num_campaigns: int, block_size: int,
                          reduce_blocks: int, offset: int = 0
                          ) -> torch.Tensor:
    """(S, G, C) canonical partials of resolved events, added in event
    order: ``winners``/``prices`` (S, n) are global events ``[offset,
    offset + n)``, and lane s adds those inside its window ``[lo[s],
    hi[s])``. One launch for all S lanes, or one per campaign chunk
    (:func:`by_campaign_chunks`) when C is above ``sp_max_campaigns()``."""
    binding.require_cuda(winners)
    lib = _lib()
    s, n = winners.shape
    dev = winners.device
    ptrs = [
        _check("winners", winners, torch.int32, (s, n), dev),
        _check("prices", prices, torch.float32, (s, n), dev),
        _check("lo", lo, torch.int32, (s,), dev),
        _check("hi", hi, torch.int32, (s,), dev),
    ]

    def launch(w: torch.Tensor, c: int) -> torch.Tensor:
        parts = torch.empty((s, reduce_blocks, c), dtype=torch.float32,
                            device=dev)
        err = lib.sp_segment_partials(
            w.data_ptr(), *ptrs[1:], parts.data_ptr(), s, n, c, int(offset),
            block_size, reduce_blocks, binding.stream(dev))
        binding.raise_on(err, "segment_partials_kernel")
        LAUNCHES["segment_partials"] += 1
        return parts

    limit = lib.sp_max_campaigns()
    if num_campaigns <= limit:
        return launch(winners, num_campaigns)
    LAUNCHES["segment_partials_chunked"] += 1
    return by_campaign_chunks(launch, winners, num_campaigns, limit)
