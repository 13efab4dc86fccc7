"""Public wrappers of the fused-round kernels (port of
``repro.kernels.auction_resolve.ops:124,169``).

They dispatch on the tensors' device: a CUDA tensor goes to the hand-written
CUDA kernel (:mod:`.round_fused`), which launches or raises; a CPU tensor
goes to the plain PyTorch version (:mod:`.ref`), because the caller asked
for the CPU. There is no padding: the kernels take any N and C.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.auction_resolve import ref
from repro_torch.kernels.auction_resolve import round_fused as cuda_kernels


def _lane_inputs(multipliers, active, reserves, n_scenarios, device):
    mult = multipliers.to(device=device, dtype=torch.float32).contiguous()
    act = active.to(device=device, dtype=torch.bool).contiguous()
    res = torch.as_tensor(reserves, dtype=torch.float32, device=device)
    return mult, act, res.expand(n_scenarios).contiguous()


def _i32(x, device, n_scenarios):
    return torch.as_tensor(x, dtype=torch.int32, device=device).expand(
        n_scenarios).contiguous()


def round_fused(values: torch.Tensor, multipliers: torch.Tensor,
                active: torch.Tensor, reserves, budgets: torch.Tensor,
                s_hat: torch.Tensor, n_hat: torch.Tensor,
                lane_alive: torch.Tensor, *, reduce_blocks: int,
                second_price: bool = False, skip_retired: bool = True):
    """One fused Algorithm-2 round for S lanes: resolve, rate partials over
    ``[n_hat, N)``, cap-out prediction, block partials over ``[n_hat,
    n_next)``. Returns ``(rate_parts (S, G, C), block_parts (S, G, C),
    c_next (S,) int32, no_cap (S,) bool, n_next (S,) int32)``; fold a
    partials tensor over G with ``segments.fold_blocks``.

    On CUDA, lanes with ``lane_alive`` False do no work when
    ``skip_retired`` (their outputs are zeros, discarded by the drivers);
    the plain CPU version computes every lane."""
    n, _ = values.shape
    s = multipliers.shape[0]
    dev = values.device
    block_size = -(-n // reduce_blocks)
    mult, act, res = _lane_inputs(multipliers, active, reserves, s, dev)
    n_hat = _i32(n_hat, dev, s)
    b = budgets.to(device=dev, dtype=torch.float32).contiguous()
    sh = s_hat.to(device=dev, dtype=torch.float32).contiguous()
    if dev.type == "cpu":
        return ref.round_fused_ref(values, mult, act, res, b, sh, n_hat,
                                   block_size=block_size,
                                   reduce_blocks=reduce_blocks,
                                   second_price=second_price)
    return cuda_kernels.round_fused_cuda(
        values, mult, act, res, b, sh, n_hat,
        lane_alive.to(torch.bool).contiguous(), block_size=block_size,
        reduce_blocks=reduce_blocks, second_price=second_price,
        skip_retired=skip_retired)


def sweep_partials(values: torch.Tensor, multipliers: torch.Tensor,
                   active: torch.Tensor, reserves, lo, hi,
                   lane_alive: torch.Tensor, offset: int = 0, *,
                   n_events_global: int, reduce_blocks: int,
                   second_price: bool = False,
                   skip_retired: bool = True) -> torch.Tensor:
    """One fused resolve+reduce pass over a slice of the log: (S, G, C)
    canonical partials of the events in each lane's global window ``[lo,
    hi)``, the slice's rows placed on the global grid at ``offset``."""
    n_local, _ = values.shape
    s = multipliers.shape[0]
    dev = values.device
    block_size = -(-n_events_global // reduce_blocks)
    mult, act, res = _lane_inputs(multipliers, active, reserves, s, dev)
    lo, hi = _i32(lo, dev, s), _i32(hi, dev, s)
    if dev.type == "cpu":
        return ref.fused_partials_ref(values, mult, act, res, lo, hi,
                                      block_size=block_size,
                                      reduce_blocks=reduce_blocks,
                                      second_price=second_price,
                                      index_offset=int(offset))
    return cuda_kernels.sweep_partials_cuda(
        values, mult, act, res, lo, hi, lane_alive.to(torch.bool).contiguous(),
        offset=int(offset), n_global=n_events_global, block_size=block_size,
        reduce_blocks=reduce_blocks, second_price=second_price,
        skip_retired=skip_retired)
