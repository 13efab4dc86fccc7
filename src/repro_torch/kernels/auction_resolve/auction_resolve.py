"""``ctypes`` wrappers of the resolve kernels of ``csrc/auction_resolve.cu``,
the port of ``repro``'s ``auction_resolve_pallas``: valuations read from a
valuation matrix for S lanes at once (:func:`resolve_lanes_cuda`; one lane,
possibly under an (N, C) mask, :func:`resolve_matrix_cuda`) or computed from
embeddings for one design (:func:`resolve_emb_cuda`). They follow
:mod:`repro_torch.kernels.binding` and count their launches in
:data:`LAUNCHES`: ``"auction_resolve"`` each resolve launch (either
kernel), ``"auction_resolve_merge"`` each merge of the matrix kernel's
campaign chunks. The kernels return winners and prices; :mod:`.ops` adds
the spend sums with ``first_crossing``'s flat sum.

The matrix kernel takes any C: a row tile's columns go to campaign chunks
(:func:`chunk_plan`) merged exactly by a second launch. It copies 16 bytes
at a time, so the valuation matrix must start on a 16-byte boundary (an
(N, C) mask on a 4-byte one); the wrapper refuses other tensors, as the
flash-attention wrapper does, rather than copy them. The embedding
kernel's shared memory holds EmbTile's embeddings of at most
:func:`emb_max_campaigns` campaigns; the wrapper refuses more, and
:mod:`.ops` resolves such calls in campaign chunks.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"auction_resolve": 0, "auction_resolve_merge": 0}

ROWS_PER_CTA = 128          # kRows of the kernel: EmbTile stages 128*d floats
# the matrix kernel: rows a CTA, floats a staged window (kTileRows, kWin)
TILE_ROWS, WINDOW = 128, 64

_SIGNATURES = {
    "ar_resolve_lanes": [_P] * 10 + [_I] * 7 + [_P],
    "ar_merge_chunks": [_P] * 5 + [_I] * 4 + [_P],
    "ar_resolve_emb": [_P, _P, _I, _I, ctypes.c_float] + [_P] * 6
    + [_I] * 4 + [_P],
    "ar_max_shared_floats": [],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("auction_resolve", _SIGNATURES)


def max_shared_floats() -> int:
    """Floats of shared memory the kernel has for EmbTile's embeddings;
    builds the kernel."""
    return _lib().ar_max_shared_floats()


def emb_max_campaigns(d: int) -> int:
    """The largest C whose EmbTile embeddings, C·d + 128·d floats, fit."""
    return max_shared_floats() // d - ROWS_PER_CTA


def chunk_plan(n: int, c: int, n_sms: int) -> tuple[int, int]:
    """``(chunks, chunk_cols)`` of the matrix kernel for N rows and C
    campaigns on a card of ``n_sms`` SMs: enough campaign chunks that the
    ``ceil(N / 128)`` row tiles make about ``2 * n_sms`` CTAs, each chunk
    at least a 64-column window wide; one chunk once the row tiles alone
    make ``2 * n_sms`` CTAs (from N=33,665 on 132 SMs)."""
    tiles = -(-n // TILE_ROWS)
    k = max(1, min(-(-2 * n_sms // tiles), -(-c // WINDOW)))
    cols = -(-c // k)
    return -(-c // cols), cols


def _lane_ptrs(mult, act, live, reserve, n, c, dev):
    per_event = act.ndim == 2
    ptrs = [
        _check("multipliers", mult, torch.float32, (c,), dev),
        _check("active", act, torch.bool, (n, c) if per_event else (c,), dev),
        None if live is None else _check("live", live, torch.bool, (n,), dev),
        _check("reserve", reserve, torch.float32, (), dev),
    ]
    return ptrs, per_event


def _resolve(values, mult, act, reserves, live, *, second_price, per_event,
             parts: bool):
    """One ``matrix_lanes_kernel`` launch; returns ``(winners, prices)``
    (S, N) when ``parts`` is False and the columns take one chunk, else
    the per-chunk ``(best, second, win)`` (S, K, N)."""
    binding.require_cuda(values)
    n, c = values.shape
    s = mult.shape[0]
    dev = values.device
    if per_event and s != 1:
        raise ValueError(f"an (N, C) mask takes one lane, got S={s}")
    lib = _lib()
    v_ptr = _check("values", values, torch.float32, (n, c), dev)
    if v_ptr % 16:
        raise ValueError("values must start on a 16-byte boundary for the "
                         "kernel's copies")
    ptrs = [
        _check("multipliers", mult, torch.float32, (s, c), dev),
        _check("active", act, torch.bool, (n, c) if per_event else (s, c),
               dev),
        None if live is None else _check("live", live, torch.bool, (n,), dev),
        _check("reserves", reserves, torch.float32, (s,), dev),
    ]
    if per_event and ptrs[1] % 4:
        raise ValueError("an (N, C) mask must start on a 4-byte boundary "
                         "for the kernel's copies")
    chunks, cols = chunk_plan(n, c, _sm_count(dev))
    if parts or chunks > 1:
        out = tuple(torch.empty((s, chunks, n), dtype=dt, device=dev)
                    for dt in (torch.float32, torch.float32, torch.int32))
        out_ptrs = [None, None] + [t.data_ptr() for t in out]
    else:
        out = (torch.empty((s, n), dtype=torch.int32, device=dev),
               torch.empty((s, n), dtype=torch.float32, device=dev))
        out_ptrs = [t.data_ptr() for t in out] + [None] * 3
    err = lib.ar_resolve_lanes(v_ptr, *ptrs, *out_ptrs, n, c, s, chunks, cols,
                               int(per_event), int(second_price),
                               binding.stream(dev))
    binding.raise_on(err, "matrix_lanes_kernel")
    LAUNCHES["auction_resolve"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def merge_chunks_cuda(best: torch.Tensor, sec: torch.Tensor,
                      win: torch.Tensor, *, second_price: bool):
    """The campaign chunks' ``(best, second, win)`` (S, K, N) of one
    resolve merged in ascending column order (``merge_kernel``, one
    launch). Returns ``(winners (S, N) int32, prices (S, N) float32)``."""
    binding.require_cuda(best)
    s, k, n = best.shape
    dev = best.device
    ptrs = [_check("best", best, torch.float32, (s, k, n), dev),
            _check("second", sec, torch.float32, (s, k, n), dev),
            _check("win", win, torch.int32, (s, k, n), dev)]
    winners = torch.empty((s, n), dtype=torch.int32, device=dev)
    prices = torch.empty((s, n), dtype=torch.float32, device=dev)
    err = _lib().ar_merge_chunks(*ptrs, winners.data_ptr(), prices.data_ptr(),
                                 n, s, k, int(second_price),
                                 binding.stream(dev))
    binding.raise_on(err, "merge_kernel")
    LAUNCHES["auction_resolve_merge"] += 1
    return winners, prices


def resolve_chunks_cuda(values: torch.Tensor, mult: torch.Tensor,
                        act: torch.Tensor, reserves: torch.Tensor, *,
                        second_price: bool):
    """The resolve launch of :func:`resolve_lanes_cuda` alone: each lane's
    ``(best, second, win)`` per campaign chunk (:func:`chunk_plan`) and
    row, (S, K, N) each, as :func:`merge_chunks_cuda` takes them."""
    return _resolve(values, mult, act, reserves, None,
                    second_price=second_price, per_event=False, parts=True)


def resolve_lanes_cuda(values: torch.Tensor, mult: torch.Tensor,
                       act: torch.Tensor, reserves: torch.Tensor,
                       live: torch.Tensor | None = None, *,
                       second_price: bool, per_event: bool = False):
    """Resolve S lanes of the N events of a valuation matrix (N, C) in one
    launch: multipliers (S, C), activations (S, C) (or, with
    ``per_event`` and S=1, an (N, C) mask), reserves (S,), optional live
    rows (N,). One resolve launch, and one merge launch when the columns
    go to more than one campaign chunk. Returns ``(winners (S, N) int32,
    prices (S, N) float32)``."""
    out = _resolve(values, mult, act, reserves, live,
                   second_price=second_price, per_event=per_event,
                   parts=False)
    if len(out) == 2:
        return out
    return merge_chunks_cuda(*out, second_price=second_price)


def resolve_matrix_cuda(values: torch.Tensor, mult: torch.Tensor,
                        act: torch.Tensor, live: torch.Tensor | None,
                        reserve: torch.Tensor, *, second_price: bool):
    """Resolve the N events of a valuation matrix (N, C) for one design
    under a (C,) or (N, C) activation and optional live rows (N,):
    :func:`resolve_lanes_cuda` at S=1. Returns ``(winners (N,) int32,
    prices (N,) float32)``."""
    binding.require_cuda(values)
    n, c = values.shape
    per_event = act.ndim == 2
    _check("multipliers", mult, torch.float32, (c,), values.device)
    _check("active", act, torch.bool, (n, c) if per_event else (c,),
           values.device)
    _check("reserve", reserve, torch.float32, (), values.device)
    winners, prices = resolve_lanes_cuda(
        values, mult[None], act if per_event else act[None], reserve[None],
        live, second_price=second_price, per_event=per_event)
    return winners[0], prices[0]


def _outputs(n, dev):
    return (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev))


def resolve_emb_cuda(event_emb: torch.Tensor, campaign_emb: torch.Tensor,
                     mult: torch.Tensor, act: torch.Tensor,
                     live: torch.Tensor | None, reserve: torch.Tensor, *,
                     second_price: bool):
    """Resolve N events whose valuations are Eq. 12 of event embeddings
    (N, d) and campaign embeddings (C, d), both float32 or both bf16.
    Returns ``(winners (N,) int32, prices (N,) float32)``."""
    binding.require_cuda(event_emb)
    lib = _lib()
    n, d = event_emb.shape
    c = campaign_emb.shape[0]
    dev = event_emb.device
    dtype = event_emb.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"embeddings have dtype {dtype}, expected float32 "
                         "or bfloat16")
    binding.check_campaigns(c, emb_max_campaigns(d),
                            f"auction_resolve EmbTile (d={d})")
    ptrs, per_event = _lane_ptrs(mult, act, live, reserve, n, c, dev)
    winners, prices = _outputs(n, dev)
    err = lib.ar_resolve_emb(
        _check("event_emb", event_emb, dtype, (n, d), dev),
        _check("campaign_emb", campaign_emb, dtype, (c, d), dev),
        int(dtype == torch.bfloat16), d, inv_scale(d), *ptrs,
        winners.data_ptr(), prices.data_ptr(), n, c, int(per_event),
        int(second_price), binding.stream(dev))
    binding.raise_on(err, "auction_resolve_kernel")
    LAUNCHES["auction_resolve"] += 1
    return winners, prices


def inv_scale(d: int) -> float:
    """Eq. 12's logit scale ``1 / (2 sqrt d)``, the float the TPU kernel
    multiplies by (rounded to float32 where it is used)."""
    return 1.0 / (2.0 * math.sqrt(d))
