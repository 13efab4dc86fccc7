"""Public wrappers of the auction-resolve kernels (port of
``repro.kernels.auction_resolve.ops``).

They dispatch on the tensors' device: a CUDA tensor goes to the hand-written
CUDA kernel (:mod:`.round_fused`, :mod:`.sweep_resolve`,
:mod:`.auction_resolve`), which launches or
raises; a CPU tensor goes to the plain PyTorch version (:mod:`.ref`),
because the caller asked for the CPU. There is no padding: the kernels take
any N and C.
"""
from __future__ import annotations

import torch

from repro_torch.core.segments import REDUCE_BLOCKS
from repro_torch.kernels.auction_resolve import ref
from repro_torch.kernels.auction_resolve.auction_resolve import (
    resolve_emb_cuda, resolve_matrix_cuda)
from repro_torch.kernels.auction_resolve import round_fused as cuda_kernels
from repro_torch.kernels.auction_resolve.sweep_resolve import \
    sweep_resolve_cuda


def _lane_inputs(multipliers, active, reserves, n_scenarios, device):
    mult = multipliers.to(device=device, dtype=torch.float32).contiguous()
    act = active.to(device=device, dtype=torch.bool).contiguous()
    res = torch.as_tensor(reserves, dtype=torch.float32, device=device)
    return mult, act, res.expand(n_scenarios).contiguous()


def _i32(x, device, n_scenarios):
    return torch.as_tensor(x, dtype=torch.int32, device=device).expand(
        n_scenarios).contiguous()


def _design_inputs(multipliers, active, reserve, live, device):
    mult = multipliers.to(device=device, dtype=torch.float32).contiguous()
    act = active.to(device=device, dtype=torch.bool).contiguous()
    res = torch.as_tensor(reserve, dtype=torch.float32,
                          device=device).reshape(())
    if live is not None:
        live = live.to(device=device, dtype=torch.bool).contiguous()
    return mult, act, res, live


def auction_resolve(event_emb: torch.Tensor, campaign_emb: torch.Tensor,
                    multipliers: torch.Tensor, active: torch.Tensor,
                    reserve=0.0, *, second_price: bool = False):
    """One design's auctions with valuations built from embeddings (Eq.
    12): event embeddings (N, d), campaign embeddings (C, d) (float32 or
    bf16), multipliers (C,), a (C,) or (N, C) activation. Returns
    ``(winners (N,) int32 [-1 = no sale], prices (N,) float32, spend sums
    (C,) float32)``, the sums added in event order. Any N, C and d."""
    dev = event_emb.device
    mult, act, res, _ = _design_inputs(multipliers, active, reserve, None,
                                       dev)
    if dev.type == "cpu":
        return ref.auction_resolve_ref(event_emb, campaign_emb, mult, act,
                                       res, second_price=second_price)
    e, r = event_emb, campaign_emb.to(dev)
    if e.dtype != r.dtype or e.dtype != torch.bfloat16:
        e, r = e.to(torch.float32), r.to(torch.float32)   # exact widening
    return resolve_emb_cuda(e.contiguous(), r.contiguous(), mult, act, None,
                            res, second_price=second_price, want_sums=True)


def resolve_masked(values: torch.Tensor, multipliers: torch.Tensor,
                   active: torch.Tensor, reserve, live=None, *,
                   second_price: bool = False, sums: bool = True):
    """One design's auctions over a valuation matrix ``values`` (N, C)
    under a (C,) or (N, C) activation; rows whose ``live`` (N,) is False
    are not sold. Returns ``(winners (N,) int32, prices (N,) float32, spend
    sums (C,) float32 or None when ``sums`` is False)``, the sums added in
    event order. The resolve of SORT2AGGREGATE's segment replays and
    Algorithm 4's batches."""
    dev = values.device
    mult, act, res, live = _design_inputs(multipliers, active, reserve, live,
                                          dev)
    if dev.type == "cpu":
        winners, prices, total = ref.resolve_masked_ref(
            values, mult, act, res, live, second_price=second_price)
        return winners, prices, total if sums else None
    return resolve_matrix_cuda(values.to(torch.float32).contiguous(), mult,
                               act, live, res, second_price=second_price,
                               want_sums=sums)


def sweep_resolve(values: torch.Tensor, multipliers: torch.Tensor,
                  active: torch.Tensor, reserves=0.0, *,
                  second_price: bool = False):
    """Resolve S scenario lanes against one (N, C) valuation matrix under
    an (S, C) or (S, N, C) activation. Returns ``(winners (S, N) int32
    [-1 = no sale], prices (S, N) float32, spend sums (S, C) float32)``;
    winners and prices are bit for bit the per-lane
    ``repro_torch.core.auction.resolve``."""
    s = multipliers.shape[0]
    dev = values.device
    mult, act, res = _lane_inputs(multipliers, active, reserves, s, dev)
    if dev.type == "cpu":
        return ref.sweep_resolve_ref(values, mult, act, res,
                                     second_price=second_price)
    return sweep_resolve_cuda(values, mult, act, res,
                              second_price=second_price,
                              reduce_blocks=REDUCE_BLOCKS)


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
