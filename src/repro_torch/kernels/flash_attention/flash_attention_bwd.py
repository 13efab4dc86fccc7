"""``ctypes`` wrapper of the flash-attention backward CUDA kernels
(``csrc/flash_attention_bwd.cu``): the gradient of
:func:`.flash_attention.flash_attention_cuda` for training. It follows
:mod:`repro_torch.kernels.binding` and counts its calls in
:data:`LAUNCHES` (one a call; a call is three device kernels: the row sums
``D = rowsum(dO * O)``, then dK and dV, then dQ; four for bfloat16 at
dh=256, where dV and dK are two launches), and those of them that took the
bfloat16 tensor-core route (``mma.sync``) in :data:`TENSOR_CORE_LAUNCHES`;
float32 takes the CUDA-core kernels.

It replaces no Pallas kernel: ``repro`` takes this gradient from XLA's
autodiff of ``repro/models/attention.py:103`` ``causal_attention``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check
from repro_torch.kernels.flash_attention.flash_attention import (_DTYPES,
                                                                 validate)

LAUNCHES = {"flash_attention_bwd": 0}
TENSOR_CORE_LAUNCHES = {"flash_attention_bwd": 0}

_SIGNATURES = {"fa_backward": [_P] * 10 + [_I] * 8 + [_P]}


def reset_launches() -> None:
    LAUNCHES["flash_attention_bwd"] = 0
    TENSOR_CORE_LAUNCHES["flash_attention_bwd"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("flash_attention_bwd", _SIGNATURES)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None):
    """The gradients ``(dq (B, S, H, dh), dk, dv (B, S, KV, dh))`` in q's
    dtype of attention of q over k, v (as the forward's arguments), given
    its output ``o`` and the output's gradient ``do`` (B, S, H, dh) and the
    forward's row logsumexp ``lse`` (B, H, S) float32. All contiguous CUDA
    tensors; one call, three launches (four for bfloat16 at dh=256);
    raises on a failed launch."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    dev = q.device
    ptrs = validate(q, k, v, window, "flash_attention_bwd")
    ptrs += [_check("o", o, q.dtype, (b, s, h, dh), dev),
             _check("do", do, q.dtype, (b, s, h, dh), dev),
             _check("lse", lse, torch.float32, (b, h, s), dev)]
    for name, t in (("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the kernel's loads")
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    err = _lib().fa_backward(*ptrs, delta.data_ptr(), dq.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(), b, s, h, kv, dh,
                             int(causal), -1 if window is None else window,
                             _DTYPES[q.dtype], binding.stream(dev))
    binding.raise_on(err, "flash_attention_bwd_kernel")
    LAUNCHES["flash_attention_bwd"] += 1
    if q.dtype == torch.bfloat16:
        TENSOR_CORE_LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
