"""Common-random-numbers (CRN) streams for scenario families (port of
``repro.core.crn``).

A scenario delta is trustworthy only when every scenario sees the same
random world and differs through its intervention alone. So every draw
belongs to one **(event, campaign)** cell and comes from the cell's own
key,

    fold_in(fold_in(fold_in(family_key, STREAM), global_event_index), campaign)

which depends on the family key, the stream name and the cell's *global*
identity only: never on the scenario, the device, the chunk schedule or how
many scenarios ride in the batch. Every lane reuses the same draws, and a
slice of the log asks for exactly the draws the whole log would give it.

The bits are ``repro``'s: the keys are :mod:`repro_torch.prng`'s threefry,
the normals :func:`repro_torch.prng.normal`, the uniforms
:func:`repro_torch.prng.uniform`, all integer arithmetic and IEEE float32
operations. A draw runs on the device it is asked for (by default the
event indices'), whatever device the key was made on, and gives the same
bits there: on CUDA the (event, campaign) draws are one launch of the
``crn_cells`` kernel (:mod:`repro_torch.kernels.crn`); on the CPU its
plain version runs in blocks of events into one preallocated float32
tensor, so the hash's temporaries stay a block's size whatever the log's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.device import DeviceLike
from repro_torch.kernels import crn as crn_ops

# Stream namespace: stable small ints folded into the family key first.
# Append-only: renumbering changes every downstream draw.
STREAMS = {
    "bid_noise": 0,          # multiplicative log-normal bid perturbations
    "participation": 1,      # per-(event, campaign) participation coin
    "entrant_value": 2,      # synthetic valuation columns for AddEntrant
    "multiplier_jitter": 3,  # per-campaign design jitter (compile-time)
}

# cells the plain version draws at once: bounds the threefry temporaries
BLOCK_CELLS = 1 << 21


def stream_key(key: torch.Tensor, stream: str) -> torch.Tensor:
    """The family key specialised to one named stream."""
    if stream not in STREAMS:
        names = ", ".join(sorted(STREAMS))
        raise ValueError(f"unknown CRN stream: {stream!r} (one of {names})")
    return prng.fold_in(key, STREAMS[stream])


def _event_idx(event_idx, device) -> torch.Tensor:
    idx = torch.as_tensor(event_idx)
    dev = idx.device if device is None else torch.device(device)
    # repro folds in the int32 index's 32 bits
    return idx.to(device=dev, dtype=torch.int32).to(torch.int64)


def _cell_keys(key: torch.Tensor, event_idx, n_campaigns: int, *,
               device: DeviceLike = None) -> torch.Tensor:
    """(T, C, 2) per-cell keys from global event indices, on ``device``
    (by default the indices')."""
    idx = _event_idx(event_idx, device)
    return crn_ops.cell_keys(key.to(idx.device), idx, n_campaigns)


def _draw_cells(normal: bool, key: torch.Tensor, event_idx,
                n_campaigns: int, device: DeviceLike,
                out: Optional[torch.Tensor]) -> torch.Tensor:
    """The (T, C) draws into ``out``: one ``crn_cells`` launch on CUDA,
    blocks of :data:`BLOCK_CELLS` cells of the plain version on the
    CPU."""
    idx = _event_idx(event_idx, device)
    t = idx.shape[0]
    if out is None:
        out = torch.empty((t, n_campaigns), dtype=torch.float32,
                          device=idx.device)
    elif out.shape != (t, n_campaigns) or out.dtype != torch.float32 \
            or out.device != idx.device:
        raise ValueError(
            f"out must be float32 {(t, n_campaigns)} on {idx.device}, got "
            f"{out.dtype} {tuple(out.shape)} on {out.device}")
    key = key.to(idx.device)
    rows = t if idx.device.type == "cuda" else \
        max(1, BLOCK_CELLS // max(1, n_campaigns))
    for lo in range(0, t, rows):
        crn_ops.crn_cells(key, idx[lo:lo + rows], n_campaigns,
                          normal=normal, out=out[lo:lo + rows])
    return out


def event_campaign_normals(key: torch.Tensor, event_idx, n_campaigns: int,
                           *, device: DeviceLike = None,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """(T, C) standard normals, one independent draw per (event, campaign)
    cell, on ``device`` (by default the indices'), into ``out`` when
    given. Bitwise the same for a cell whichever slice of the log asks for
    it, and whatever the block."""
    return _draw_cells(True, key, event_idx, n_campaigns, device, out)


def event_campaign_uniforms(key: torch.Tensor, event_idx, n_campaigns: int,
                            *, device: DeviceLike = None,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """(T, C) uniforms in [0, 1), one per (event, campaign) cell (as
    :func:`event_campaign_normals`)."""
    return _draw_cells(False, key, event_idx, n_campaigns, device, out)


def campaign_normals(key: torch.Tensor, n_campaigns: int, *,
                     device: DeviceLike = None) -> torch.Tensor:
    """(C,) standard normals, one per campaign: the per-campaign design
    streams (multiplier jitter), shared by every scenario; on ``device``
    (by default the key's)."""
    dev = key.device if device is None else torch.device(device)
    cvec = torch.arange(n_campaigns, dtype=torch.int64, device=dev)
    return prng.normal(prng.fold_in(key.to(dev), cvec), ())
