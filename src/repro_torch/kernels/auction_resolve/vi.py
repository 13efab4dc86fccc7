"""``ctypes`` wrapper of the Algorithm-4 kernel (``csrc/vi.cu``): every
batch of ``core.vi``'s VI iteration for S lanes in one launch, one CTA a
lane, in place of a resolve launch per batch (the counterpart of
``repro``'s ``auction_resolve_pallas``) and the host loop around it. It
follows :mod:`repro_torch.kernels.binding` and counts in :data:`LAUNCHES`
its launches (``"vi"``) and those whose state did not fit in shared memory
and lived in device memory (``"vi_device_state"``, a subset).

The plain version is ``core.vi``'s loop on the CPU, and
:func:`repro_torch.kernels.auction_resolve.ref.vi_chain_ref` mirrors the
kernel's chain on these inputs (for tests and the card's plain time). With
a scenario overlay the kernel takes each lane's perturbed rows and a
per-lane eligibility mask; without one its arguments and bits are as
before.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"vi": 0, "vi_device_state": 0}

_SIGNATURES = {
    "vi_run": [_P] * 11 + [_I] * 9 + [ctypes.c_longlong, _P],
    "vi_staged": [_I] * 4,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("vi", _SIGNATURES)


def staged(batch_size: int, num_campaigns: int, width: int,
           eligibility: bool = False) -> bool:
    """Whether a run's state and a ring of at least two staged batches
    (with a per-lane eligibility mask when ``eligibility``) fit in shared
    memory (else they live in device memory); builds the kernel."""
    return bool(_lib().vi_staged(batch_size, num_campaigns, width,
                                 int(eligibility)))


def eligibility_bytes(elig: torch.Tensor, batch_size: int) -> torch.Tensor:
    """The kernel's layout of a (S, n_batches·B, C) bool eligibility:
    (S, n_batches, EB) uint8, each batch's B·C bytes padded to EB, a
    multiple of 16."""
    s, rows, c = elig.shape
    n_batches = rows // batch_size
    per = batch_size * c
    eb = -(-per // 16) * 16
    out = torch.zeros((s, n_batches, eb), dtype=torch.uint8,
                      device=elig.device)
    out[..., :per] = elig.reshape(s, n_batches, per).to(torch.uint8)
    return out


def vi_cuda(sampled: torch.Tensor, u: torch.Tensor, step: torch.Tensor,
            denom: torch.Tensor, btilde: torch.Tensor, mult: torch.Tensor,
            reserves: torch.Tensor, pi0: torch.Tensor, *, sample_size: int,
            second_price: bool, track_every: int = 0,
            elig: torch.Tensor | None = None):
    """Algorithm 4 for S lanes on shared draws: ``sampled`` (n_batches·B,
    C) sampled valuations shared by the lanes, or (S, n_batches·B, C) one
    set a lane (rows from ``sample_size`` on are dead), ``u`` (total, B, 1
    or C) uniforms, ``step`` (total,), ``denom`` (n_batches,), and per lane
    ``btilde``, ``mult``, ``pi0`` (S, C) and ``reserves`` (S,); ``elig``
    (S, n_batches·B, C) bool, when given, is ANDed into every activation
    (a scenario overlay's eligibility). Returns ``(pi (S, C) float32,
    history (S, ceil(total / track_every), C) or None)``."""
    binding.require_cuda(sampled)
    lib = _lib()
    total, b, w = u.shape
    rows, c = sampled.shape[-2:]
    n_batches = rows // b
    s = mult.shape[0]
    dev = sampled.device
    per_lane = sampled.ndim == 3
    ptrs = [
        _check("sampled", sampled, torch.float32,
               ((s,) if per_lane else ()) + (n_batches * b, c), dev),
        _check("u", u, torch.float32, (total, b, w), dev),
        _check("step", step, torch.float32, (total,), dev),
        _check("denom", denom, torch.float32, (n_batches,), dev),
        _check("btilde", btilde, torch.float32, (s, c), dev),
        _check("multipliers", mult, torch.float32, (s, c), dev),
        _check("reserves", reserves, torch.float32, (s,), dev),
    ]
    # the kernel updates pi in place, from a copy of pi0
    pi = pi0.to(device=dev, dtype=torch.float32).clone(
        memory_format=torch.contiguous_format)
    _check("pi0", pi, torch.float32, (s, c), dev)
    history = None
    if track_every:
        history = torch.empty((s, -(-total // track_every), c),
                              dtype=torch.float32, device=dev)
    elig_ptr = None
    if elig is not None:
        _check("elig", elig, torch.bool, (s, n_batches * b, c), dev)
        elig = eligibility_bytes(elig, b)
        elig_ptr = elig.data_ptr()
    in_device_memory = not lib.vi_staged(b, c, w, int(elig is not None))
    scratch = torch.empty((s, 2 * b), dtype=torch.float32, device=dev) \
        if in_device_memory else None
    err = lib.vi_run(*ptrs, pi.data_ptr(),
                     None if history is None else history.data_ptr(),
                     None if scratch is None else scratch.data_ptr(),
                     elig_ptr, s, c, b, w, n_batches, total, sample_size,
                     track_every, int(second_price),
                     n_batches * b * c if per_lane else 0,
                     binding.stream(dev))
    binding.raise_on(err, "vi_kernel")
    if s > 0 and total > 0:
        LAUNCHES["vi"] += 1
        LAUNCHES["vi_device_state"] += int(in_device_memory)
    return pi, history

