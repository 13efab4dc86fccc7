"""What every ``ctypes`` wrapper of the port's CUDA kernels shares: load a
built library with its C signatures, check the tensors handed to it, and
raise on a launch's ``cudaError_t``.

A wrapper takes CUDA tensors only. It checks device, dtype, shape and
contiguity, allocates the outputs, launches on
``torch.cuda.current_stream()`` and raises if the launch returns a CUDA
error. It does not synchronise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

P, I = ctypes.c_void_p, ctypes.c_int


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, with ``argtypes`` set for
    each C function in ``signatures`` (every one returns an ``int``)."""
    lib = build.load(name)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
          device: torch.device) -> int:
    """``t.data_ptr()`` once ``t`` has the device, dtype and shape a kernel
    takes and is contiguous; a ``ValueError`` naming ``name`` otherwise."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError_t {err}")


def require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernels take CUDA tensors, got {t.device}")


def stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check_campaigns(n_campaigns: int, limit: int, kernel: str) -> None:
    if n_campaigns > limit:
        raise ValueError(f"C={n_campaigns} exceeds the {kernel} kernel's "
                         f"limit of {limit} campaigns")
