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

A ``meta`` tensor (the dry run) launches nothing: the forward and the
backward return empty outputs of the kernels' shapes and dtypes (with the
logsumexp) and report to :mod:`repro_torch.kernels.meta` the products of
the reference's chunked form (``repro/models/attention.py:103-164``):
query chunks of ``min(S, 512)`` rows (halved until they divide S) against
the whole key strip, or a strip of ``window + chunk`` keys, full tiles,
two products (scores, then probabilities times values) forward and five
backward (the scores recomputed, then dP, dV, dS K and dS^T Q); the share
the causal and window masks keep is reported apart.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import meta as kernel_meta
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda
from repro_torch.kernels.flash_attention.flash_attention_bwd import \
    flash_attention_bwd_cuda
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)


def _chunk(s: int, target: int = 512) -> int:
    """The reference's query chunk (``_pick_chunk``)."""
    if s <= target:
        return s
    c = target
    while s % c != 0:
        c //= 2
    return max(c, 1)


def seen_pairs(s: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the masks keep in an S x S attention."""
    if causal:
        if window is None or s <= window:
            return s * (s + 1) // 2
        return window * (window + 1) // 2 + (s - window) * window
    if window is None or s < window:
        return s * s
    return s * s - (s - window) * (s - window + 1) // 2


def _meta_work(name, inputs, outputs, roles, causal, window, products):
    q = inputs[0]
    b, s, h, dh = q.shape
    strip = s if window is None else min(s, window + _chunk(s))
    unit = 2.0 * b * h * dh
    kernel_meta.report(kernel_meta.Work(
        name, tuple(inputs), tuple(outputs), roles,
        flops=products * unit * s * strip,
        useful_flops=products * unit * seen_pairs(s, causal, window)))


def _meta_forward(q, k, v, causal, window, with_lse):
    """The forward's meta route: empty (out, lse) and their work."""
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _meta_work("flash_attention", (q, k, v),
               (out, lse) if with_lse else (out,),
               ("q", "lse") if with_lse else ("q",), causal, window, 2)
    return (out, lse) if with_lse else out


def _meta_backward(q, k, v, o, do, lse, causal, window):
    """The backward's meta route: empty (dq, dk, dv) and their work."""
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    _meta_work("flash_attention_bwd", (q, k, v, o, do, lse), grads,
               ("q", "k", "v"), causal, window, 5)
    return grads


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward saves q, k, v, the output
    and the row logsumexp; the backward recomputes the probabilities from
    them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        if q.device.type == "cpu":
            out, lse = attention_lse_ref(q, k, v, causal=causal,
                                         window=window)
        elif q.device.type == "meta":
            out, lse = _meta_forward(q, k, v, causal, window, True)
        else:
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "meta":
            dq, dk, dv = _meta_backward(q, k, v, out, dout, lse, ctx.causal,
                                        ctx.window)
            return dq, dk, dv, None, None
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
    if q.device.type == "meta":
        return _meta_forward(q, k, v, causal, window, False)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window)
