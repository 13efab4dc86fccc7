"""Public entry of the flash-attention kernel on the model's layout (port
of ``repro.kernels.flash_attention.ops:17``), for serving and training.

It dispatches on the device: a CUDA tensor goes to the hand-written kernel
(:mod:`.flash_attention`), which launches or raises; a CPU tensor goes to
the plain version (:mod:`.ref`). There is no padding and no fallback: the
kernel masks a ragged S itself, where the reference halves its blocks
until they divide S.

Where autograd records (grad enabled and q, k or v requiring a gradient)
the call goes through :class:`FlashAttention`, whose forward also keeps
each row's logsumexp and whose backward is the backward kernel
(:mod:`.flash_attention_bwd`) on the card, the plain backward
(:func:`.ref.attention_bwd_ref`) on the CPU. The reference takes this
gradient from XLA's autodiff of its attention, recomputing the score tiles
(``repro/models/attention.py:146-150``); the backward kernel recomputes
them too and stores no (S, S) tile. Otherwise (serving) the call is the
forward alone, as it was.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda
from repro_torch.kernels.flash_attention.flash_attention_bwd import \
    flash_attention_bwd_cuda
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward saves q, k, v, the output
    and the row logsumexp; the backward recomputes the probabilities from
    them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        if q.device.type == "cpu":
            out, lse = attention_lse_ref(q, k, v, causal=causal,
                                         window=window)
        else:
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        backward = (attention_bwd_ref if q.device.type == "cpu"
                    else flash_attention_bwd_cuda)
        dq, dk, dv = backward(q, k, v, out, dout.contiguous(), lse,
                              causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention of q (B, S, H, dh) over
    k, v (B, S, KV, dh), float32 scores and softmax (on bfloat16 inputs
    the kernel's tensor cores take the probabilities as two bfloat16
    terms); returns (B, S, H, dh) in q's dtype. GQA: query head h reads kv
    head ``h // (H // KV)``. Differentiable where autograd records."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.device.type != "cpu":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window)
