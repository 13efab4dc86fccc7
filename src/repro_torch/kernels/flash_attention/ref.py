"""Plain PyTorch versions of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref:12``).

:func:`flash_attention_ref` is the reference's oracle on ``(BH, S, dh)``
tensors: float32 scores scaled by ``1/sqrt(float32(dh))``, masked with
``NEG = -2**30`` (not ``-inf``), a full softmax, the output in q's dtype.
:func:`attention_ref` is the same on the model's ``(B, S, H, dh)`` layout
with grouped kv heads, what ``ops.flash_attention`` computes. The CPU path
runs them; ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
``csrc/flash_attention.cu`` against them on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG = -2.0 ** 30


def inv_sqrt(dh: int) -> float:
    """``1 / sqrt(float32(dh))`` computed in float32, as a Python float
    (a scalar operand: no tensor is copied to the card)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def repeat_kv(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """kv heads (B, S, KV, dh) laid out for ``n_heads`` query heads: query
    head h reads kv head ``h // (n_heads // KV)`` (``jnp.repeat``)."""
    rep = n_heads // x.shape[2]
    return x if rep == 1 else torch.repeat_interleave(x, rep, dim=2)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Attention of q, k, v (BH, S, dh), causal and/or with a sliding
    ``window`` (key j is seen by query i when ``j > i - window``)."""
    s, dh = q.shape[1], q.shape[-1]
    dev = q.device
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * inv_sqrt(dh)
    rows = torch.arange(s, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=dev)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    scores = torch.where(mask[None], scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention_ref` on q (B, S, H, dh) and k, v
    (B, S, KV, dh): query head h reads kv head ``h // (H // KV)``, as
    ``jnp.repeat`` lays them out in ``repro.kernels.flash_attention.ops``.
    Returns (B, S, H, dh)."""
    b, s, h, dh = q.shape
    k, v = repeat_kv(k, h), repeat_kv(v, h)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, s, dh)

    out = flash_attention_ref(fold(q), fold(k), fold(v), causal=causal,
                              window=window)
    return out.reshape(b, h, s, dh).transpose(1, 2)
