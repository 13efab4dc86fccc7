"""Public entry of the flash-attention kernel on the model's layout (port
of ``repro.kernels.flash_attention.ops:17``).

It dispatches on the device: a CUDA tensor goes to the hand-written kernel
(:mod:`.flash_attention`), which launches or raises; a CPU tensor goes to
the plain version (:func:`.ref.attention_ref`). There is no padding and no
fallback: the kernel masks a ragged S itself, where the reference halves
its blocks until they divide S.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention of q (B, S, H, dh) over
    k, v (B, S, KV, dh), float32 scores and softmax (on bfloat16 inputs
    the kernel's tensor cores take the probabilities as two bfloat16
    terms); returns (B, S, H, dh) in q's dtype. GQA: query head h reads kv
    head ``h // (H // KV)``."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window)
