"""``ctypes`` wrapper of the segment-replay kernel
(``csrc/segment_resolve.cu``): every event resolved for S lanes, each under
its own segment table, in one launch, in place of a mask gather and a
resolve launch per lane (the counterpart of ``repro``'s
``auction_resolve_pallas``). It follows :mod:`repro_torch.kernels.binding`
and counts its launches in :data:`LAUNCHES`.

The kernel streams 128-row tiles of all C columns through shared memory,
each CTA a run of tiles for 32 lanes, so it takes at most
:func:`max_campaigns` campaigns; the wrapper refuses more, and
:func:`repro_torch.kernels.auction_resolve.ops.segment_resolve` routes such
calls to the per-lane resolve.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"segment_resolve": 0}

ROWS_PER_CTA = 128        # kRows of the kernel: a tile, two rows a thread
LANE_CHUNK = 32           # kLaneChunk: the lanes a CTA resolves

_SIGNATURES = {
    "sg_segment_resolve": [_P] * 7 + [_I] * 6 + [_P],
    "sg_max_campaigns": [],
}


def reset_launches() -> None:
    LAUNCHES["segment_resolve"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("segment_resolve", _SIGNATURES)


def max_campaigns() -> int:
    """The largest C whose row tile fits in shared memory; builds the
    kernel."""
    return _lib().sg_max_campaigns()


def segment_resolve_cuda(values: torch.Tensor, mult: torch.Tensor,
                         reserves: torch.Tensor, boundaries: torch.Tensor,
                         masks: torch.Tensor, *, second_price: bool,
                         offset: int = 0):
    """Resolve the N events of ``values`` (N, C) for S lanes, event n of
    lane s under ``masks[s, j]`` with j the segment of global event
    ``offset + n`` in ``boundaries[s]`` (``Segments.seg_ids``). ``mult``
    (S, C), ``reserves`` (S,), ``boundaries`` (S, K+2) int32 (each row
    sorted), ``masks`` (S, K+1, C) bool. Returns ``(winners (S, N) int32,
    prices (S, N) float32)``."""
    binding.require_cuda(values)
    lib = _lib()
    n, c = values.shape
    s, k2 = boundaries.shape
    dev = values.device
    binding.check_campaigns(c, lib.sg_max_campaigns(), "segment_resolve")
    ptrs = [
        _check("values", values, torch.float32, (n, c), dev),
        _check("multipliers", mult, torch.float32, (s, c), dev),
        _check("reserves", reserves, torch.float32, (s,), dev),
        _check("boundaries", boundaries, torch.int32, (s, k2), dev),
        _check("masks", masks, torch.bool, (s, k2 - 1, c), dev),
    ]
    if offset < 0:
        raise ValueError(f"row offset must be >= 0, got {offset}")
    winners = torch.empty((s, n), dtype=torch.int32, device=dev)
    prices = torch.empty((s, n), dtype=torch.float32, device=dev)
    err = lib.sg_segment_resolve(*ptrs, winners.data_ptr(),
                                 prices.data_ptr(), s, n, c, k2 - 2,
                                 int(offset), int(second_price),
                                 binding.stream(dev))
    binding.raise_on(err, "segment_resolve_kernel")
    if s > 0 and n > 0:
        LAUNCHES["segment_resolve"] += 1
    return winners, prices
