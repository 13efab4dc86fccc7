"""``ctypes`` wrappers of the common-random-numbers kernels
(``csrc/crn.cu``): the (event, campaign) draws of the scenario families'
CRN streams and the bid noise ``v * exp(sigma * z)``.

They replace no Pallas kernel: ``repro`` draws with ``jax.random`` and
perturbs with ``jnp.exp`` (``repro/core/crn.py:58-85``,
``repro/core/executor.py:914``). Each wrapper launches its kernel for CUDA
tensors and runs its plain version, PyTorch operations with the same bits
(:func:`repro_torch.prng.normal`, :func:`repro_torch.floats.exp`), for CPU
tensors; it follows :mod:`repro_torch.kernels.binding` and counts its
launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import functools
import ctypes

import torch

from repro_torch import floats, prng
from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"crn_cells": 0, "bid_noise": 0}

_L = ctypes.c_longlong
_U = ctypes.c_uint

_SIGNATURES = {
    "crn_cells": [_U, _U, _P, _L, _L, _I, _I, _P, _P],
    "bid_noise": [_P, _P, _P, _P, _I, _L, _I, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("crn", _SIGNATURES)


def cell_keys(key: torch.Tensor, idx: torch.Tensor,
              n_campaigns: int) -> torch.Tensor:
    """(T, C, 2) keys ``fold_in(fold_in(key, idx[t]), c)``; ``idx`` int64
    words on the key's device."""
    cvec = torch.arange(n_campaigns, dtype=torch.int64, device=idx.device)
    return prng.fold_in(prng.fold_in(key, idx)[:, None, :], cvec)


def cells_plain(key: torch.Tensor, idx: torch.Tensor, n_campaigns: int,
                normal: bool) -> torch.Tensor:
    """The plain version of :func:`crn_cells`: (T, C) normals or
    uniforms of the cell keys."""
    keys = cell_keys(key.to(idx.device), idx, n_campaigns)
    return prng.normal(keys, ()) if normal else prng.uniform(keys, ())


def crn_cells(key: torch.Tensor, idx: torch.Tensor, n_campaigns: int, *,
              normal: bool, out: torch.Tensor) -> torch.Tensor:
    """Fill ``out`` (T, C) float32 with the draws of the cells of events
    ``idx`` (T,) int64 under the stream ``key``: standard normals
    (``normal``) or uniforms in [0, 1). One launch for CUDA tensors."""
    if idx.device.type != "cuda":
        out.copy_(cells_plain(key, idx, n_campaigns, normal))
        return out
    t = idx.shape[0]
    dev = idx.device
    _check("out", out, torch.float32, (t, n_campaigns), dev)
    words = [int(w) & prng.MASK for w in key.reshape(2).tolist()]
    idx32 = idx.to(torch.int32).contiguous()
    err = _lib().crn_cells(words[0], words[1], idx32.data_ptr(), 0, t,
                           n_campaigns, int(normal), out.data_ptr(),
                           binding.stream(dev))
    binding.raise_on(err, "crn_cells_kernel")
    if t > 0 and n_campaigns > 0:
        LAUNCHES["crn_cells"] += 1
    return out


def bid_noise_plain(values: torch.Tensor, z: torch.Tensor,
                    sigma: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`bid_noise`: ``values * exp(sigma *
    z)`` with XLA CPU's float32 ``exp`` (:func:`repro_torch.floats.exp`),
    (S, T, C) for ``sigma`` (S, C)."""
    return values * floats.exp(sigma[:, None, :] * z[None])


def bid_noise(values: torch.Tensor, z: torch.Tensor,
              sigma: torch.Tensor) -> torch.Tensor:
    """(S, T, C) perturbed valuations ``values * exp(sigma[s] * z)`` of
    every lane: ``values`` and ``z`` (T, C), ``sigma`` (S, C). One launch
    for CUDA tensors."""
    if values.device.type != "cuda":
        return bid_noise_plain(values, z, sigma)
    s, c = sigma.shape
    t = z.shape[0]
    dev = values.device
    out = torch.empty((s, t, c), dtype=torch.float32, device=dev)
    err = _lib().bid_noise(
        _check("values", values, torch.float32, (t, c), dev),
        _check("z", z, torch.float32, (t, c), dev),
        _check("sigma", sigma, torch.float32, (s, c), dev), out.data_ptr(),
        s, t, c, binding.stream(dev))
    binding.raise_on(err, "bid_noise_kernel")
    if s > 0 and t > 0 and c > 0:
        LAUNCHES["bid_noise"] += 1
    return out
