"""``ctypes`` wrapper of the flash-attention CUDA kernel
(``csrc/flash_attention.cu``), the port of ``repro``'s
``flash_attention_pallas``. It follows :mod:`repro_torch.kernels.binding`
and counts its launches in :data:`LAUNCHES`, and those of them with
``causal=False`` (an encoder's attention) in :data:`NON_CAUSAL_LAUNCHES`.

The kernel reads the model's ``(B, S, H, dh)`` layout directly, and query
head h reads kv head ``h // (H // KV)``: no transpose and no repeated kv
heads are materialised. ``(BH, S, dh)`` tensors, the Pallas kernel's
layout, are the case ``H = KV = 1`` (pass ``q[:, :, None]``).

Both kernels run on the tensor cores (bfloat16 tensors through bf16
``mma.sync``, float32 tensors through split TF32), copy 16 bytes at a time
(the tensors must start on a 16-byte boundary) and launch one CTA per (b,
h) along the grid's x axis and one per ``ROWS[dh]`` query rows along its
y axis, which bounds S and not B*H.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import binding
from repro_torch.kernels.binding import I as _I, P as _P, check as _check

LAUNCHES = {"flash_attention": 0}
NON_CAUSAL_LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GRID_Y = 65535          # CUDA's limit on gridDim.y
# query rows per CTA of both kernels (csrc/flash_attention.cu, TC<DH> and
# TF<DH>)
ROWS = {16: 128, 32: 128, 64: 128, 128: 128, 256: 64}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"fa_forward": [_P] * 5 + [_I] * 8 + [_P]}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0
    NON_CAUSAL_LAUNCHES["flash_attention"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    return binding.bind("flash_attention", _SIGNATURES)


def validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: Optional[int], what: str) -> list:
    """The data pointers of q (B, S, H, dh), k and v (B, S, KV, dh) once
    they are CUDA tensors of one dtype the kernels take, contiguous, on
    16-byte boundaries, of a head dim and S the kernels take, with H a
    multiple of KV and a positive window if any; ``ValueError`` naming
    ``what`` otherwise."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what} takes float32 or bfloat16, got {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what} takes head dims {HEAD_DIMS}, got {dh}")
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group onto {kv} kv heads")
    tiles = -(-s // ROWS[dh])
    if tiles > MAX_GRID_Y:
        raise ValueError(f"S={s} is {tiles} query tiles of {ROWS[dh]} "
                         f"rows, beyond the kernel's grid limit of "
                         f"{MAX_GRID_Y}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the kernel's copies")
    if window is not None and window < 1:
        raise ValueError(f"a window must be positive, got {window}")
    binding.require_cuda(q)
    return [
        _check("q", q, q.dtype, (b, s, h, dh), dev),
        _check("k", k, q.dtype, (b, s, kv, dh), dev),
        _check("v", v, q.dtype, (b, s, kv, dh), dev),
    ]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None, with_lse: bool = False):
    """Attention of q (B, S, H, dh) over k, v (B, S, KV, dh), all float32
    or all bfloat16 and contiguous; causal and/or with a sliding
    ``window``. One launch; returns (B, S, H, dh) in q's dtype, and with
    ``with_lse`` also each row's logsumexp of its scaled, masked scores,
    (B, H, S) float32, which the backward recomputes the probabilities
    from."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    dev = q.device
    ptrs = validate(q, k, v, window, "flash_attention")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=dev)
           if with_lse else None)
    lib = _lib()
    err = lib.fa_forward(*ptrs, out.data_ptr(),
                         None if lse is None else lse.data_ptr(), b, s, h,
                         kv, dh, int(causal),
                         -1 if window is None else window, _DTYPES[q.dtype],
                         binding.stream(dev))
    binding.raise_on(err, "flash_attention_kernel")
    LAUNCHES["flash_attention"] += 1
    if not causal:
        NON_CAUSAL_LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out
