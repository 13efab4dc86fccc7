"""``ctypes`` wrapper of the first-crossing kernel
(``csrc/first_crossing.cu``).

It replaces no Pallas kernel: on the TPU, XLA computes
``repro.core.segments.first_crossing_times`` (a blockwise ``jnp.cumsum``)
and ``auction.spend_sums`` (a segment sum). The kernel gives both in the
reference's float order; :mod:`repro_torch.core.segments` and
:mod:`repro_torch.core.auction` send CUDA tensors here, and keep the plain
versions (``first_crossing_ref``, ``index_add_``) for CPU tensors. The
wrapper follows :mod:`repro_torch.kernels.binding` and counts in
:data:`LAUNCHES` its calls (``"first_crossing"``, one per call) and the
device kernels they ran (``"first_crossing_device_kernels"``, as the
library counts them): four a call (the tiles' sums, the chains, the
crossings, the flat sums; ``csrc/first_crossing.cu``), three when the call
asks for the cap times only (:func:`first_crossing_cuda`'s ``spend=False``:
no flat sums), and the tile passes none at N = 0. A call may carry the
running spend and the cap times of the rows before it (``carry``): the
chunked SORT2AGGREGATE replay calls it once a chunk.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"first_crossing": 0, "first_crossing_device_kernels": 0}

_SIGNATURES = {"fc_first_crossing": [_P] * 9 + [_I] * 6 + [_P],
               "fc_scratch_bytes": [_I] * 5,
               "fc_device_kernels": []}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = binding.bind("first_crossing", _SIGNATURES)
    lib.fc_scratch_bytes.restype = ctypes.c_longlong
    lib.fc_device_kernels.restype = ctypes.c_longlong
    return lib


def first_crossing_cuda(winners: torch.Tensor, prices: torch.Tensor,
                        budgets: torch.Tensor | None, *, num_campaigns: int,
                        block: int = 4096, carry=None, spend: bool = True):
    """S lanes of resolved events, winners (S, N) int32 and prices (S, N)
    float32. Returns ``(cap times (S, C) int32, spend (S, C) float32)``:
    the flat per-campaign sums in event order (None with ``spend=False``,
    which skips them) and, when ``budgets`` (S, C) is given, the first
    crossings of the blockwise running spend in XLA's cumsum order (None
    without budgets). One call for all lanes.

    ``carry = (s0 (S, C) float32, cap (S, C) int32, offset, n_global)``
    (budgets required) makes the rows global events ``[offset, offset +
    N)`` of a log of ``n_global``, ``offset`` a multiple of ``block``: the
    running spend starts at ``s0``, the cap times at ``cap`` (sentinel
    ``n_global + 1``), crossings are global 1-based times, and the call
    returns ``(cap, spend, s0 after the last row)``."""
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
    if budgets is None and not spend:
        raise ValueError("a first-crossing call without budgets computes "
                         "the spends only")
    offset, sentinel, s0_out = 0, n + 1, None
    carry_ptrs = [None, None]
    if carry is not None:
        if budgets is None:
            raise ValueError("a first-crossing carry needs budgets")
        s0_in, cap_in, offset, n_global = carry
        if offset % block or not 0 <= offset <= n_global - n:
            raise ValueError(
                f"rows [{offset}, {offset + n}) of a log of {n_global} "
                f"events must start on a crossing block of {block}")
        sentinel = n_global + 1
        carry_ptrs = [_check("s0", s0_in, torch.float32, (s, c), dev),
                      _check("cap", cap_in, torch.int32, (s, c), dev)]
        s0_out = torch.empty((s, c), dtype=torch.float32, device=dev)
    cap = None if budgets is None else torch.empty(
        (s, c), dtype=torch.int32, device=dev)
    sums = torch.empty((s, c), dtype=torch.float32, device=dev) \
        if spend else None
    modes = (budgets is not None) | (2 if spend else 0)
    scratch = torch.empty(lib.fc_scratch_bytes(s, n, c, block, modes),
                          dtype=torch.uint8, device=dev)
    before = lib.fc_device_kernels()
    err = lib.fc_first_crossing(
        *ptrs, *carry_ptrs, None if cap is None else cap.data_ptr(),
        None if sums is None else sums.data_ptr(),
        None if s0_out is None else s0_out.data_ptr(),
        scratch.data_ptr(), s, n, c, block, offset, sentinel,
        binding.stream(dev))
    binding.raise_on(err, "first_crossing_kernel")
    LAUNCHES["first_crossing"] += 1
    LAUNCHES["first_crossing_device_kernels"] += \
        lib.fc_device_kernels() - before
    return (cap, sums) if carry is None else (cap, sums, s0_out)
