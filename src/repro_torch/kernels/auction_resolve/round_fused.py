"""``ctypes`` wrappers of the fused-round CUDA kernels
(``csrc/round_fused.cu``), the port of ``repro``'s ``round_fused_pallas``
and ``sweep_partials_pallas``.

The wrappers follow :mod:`repro_torch.kernels.binding`: CUDA tensors only,
checked, outputs allocated here, launched on the current stream, an error
raised on a non-zero ``cudaError_t``. Each wrapper adds one to
:data:`LAUNCHES` where it launches its kernel, so a run can show that it
went through the kernels.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"round_fused": 0, "sweep_partials": 0}

_SIGNATURES = {
    "rf_sweep_partials": [_P] * 8 + [_I] * 9 + [_P],
    "rf_predict": [_P] * 8 + [_I] * 4 + [_P],
    "rf_max_campaigns": [],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("round_fused", _SIGNATURES)


def _partials(lib, values, mult, act, reserves, lo, hi, alive, *,
              offset: int, n_global: int, block_size: int, reduce_blocks: int,
              second_price: bool, skip_retired: bool) -> torch.Tensor:
    n_local, c = values.shape
    s = mult.shape[0]
    dev = values.device
    binding.check_campaigns(c, lib.rf_max_campaigns(), "partials")
    if not (0 <= offset and offset + n_local <= n_global):
        raise ValueError(f"rows [{offset}, {offset + n_local}) are not inside "
                         f"a log of {n_global} events")
    ptrs = [
        _check("values", values, torch.float32, (n_local, c), dev),
        _check("multipliers", mult, torch.float32, (s, c), dev),
        _check("active", act, torch.bool, (s, c), dev),
        _check("reserves", reserves, torch.float32, (s,), dev),
        _check("lo", lo, torch.int32, (s,), dev),
        None if hi is None else _check("hi", hi, torch.int32, (s,), dev),
        _check("lane_alive", alive, torch.bool, (s,), dev),
    ]
    parts = torch.empty((s, reduce_blocks, c), dtype=torch.float32,
                        device=dev)
    err = lib.rf_sweep_partials(
        *ptrs, parts.data_ptr(), s, n_local, c, offset, n_global, block_size,
        reduce_blocks, int(second_price), int(skip_retired),
        binding.stream(dev))
    binding.raise_on(err, "partials_kernel")
    LAUNCHES["sweep_partials"] += 1
    return parts


def sweep_partials_cuda(values, mult, act, reserves, lo, hi, alive, *,
                        offset: int, n_global: int, block_size: int,
                        reduce_blocks: int, second_price: bool,
                        skip_retired: bool) -> torch.Tensor:
    """One resolve+reduce pass: (S, G, C) canonical partials of the events
    of ``values`` (global rows ``[offset, offset + n_local)``) inside each
    lane's window ``[lo[s], hi[s])``; ``hi=None`` means the end of the log."""
    binding.require_cuda(values)
    return _partials(_lib(), values, mult, act, reserves, lo, hi, alive,
                     offset=offset, n_global=n_global, block_size=block_size,
                     reduce_blocks=reduce_blocks, second_price=second_price,
                     skip_retired=skip_retired)


def round_fused_cuda(values, mult, act, reserves, budgets, s_hat, n_hat,
                     alive, *, block_size: int, reduce_blocks: int,
                     second_price: bool, skip_retired: bool):
    """One Algorithm-2 round as three launches on the current stream:
    partials over ``[n_hat, N)``, the prediction, partials over
    ``[n_hat, n_next)`` with ``n_next`` read from device memory. Returns
    ``(rate_parts, block_parts, c_next (S,) int32, no_cap (S,) bool,
    n_next (S,) int32)``."""
    binding.require_cuda(values)
    lib = _lib()
    n, c = values.shape
    s = mult.shape[0]
    dev = values.device
    kw = dict(offset=0, n_global=n, block_size=block_size,
              reduce_blocks=reduce_blocks, second_price=second_price,
              skip_retired=skip_retired)
    rate_parts = _partials(lib, values, mult, act, reserves, n_hat, None,
                           alive, **kw)
    c_next = torch.empty(s, dtype=torch.int32, device=dev)
    no_cap = torch.empty(s, dtype=torch.bool, device=dev)
    n_next = torch.empty(s, dtype=torch.int32, device=dev)
    err = lib.rf_predict(
        rate_parts.data_ptr(),
        _check("budgets", budgets, torch.float32, (s, c), dev),
        _check("s_hat", s_hat, torch.float32, (s, c), dev),
        act.data_ptr(), n_hat.data_ptr(), c_next.data_ptr(),
        no_cap.data_ptr(), n_next.data_ptr(), s, c, reduce_blocks, n,
        binding.stream(dev))
    binding.raise_on(err, "predict_kernel")
    LAUNCHES["round_fused"] += 1
    block_parts = _partials(lib, values, mult, act, reserves, n_hat, n_next,
                            alive, **kw)
    return rate_parts, block_parts, c_next, no_cap, n_next
