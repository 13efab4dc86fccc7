"""Plain PyTorch versions of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref:12``).

:func:`flash_attention_ref` is the reference's oracle on ``(BH, S, dh)``
tensors: float32 scores scaled by ``1/sqrt(float32(dh))``, masked with
``NEG = -2**30`` (not ``-inf``), a full softmax, the output in q's dtype.
:func:`attention_ref` is the same on the model's ``(B, S, H, dh)`` layout
with grouped kv heads, what ``ops.flash_attention`` computes. The CPU path
runs them; ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
``csrc/flash_attention.cu`` against them on the card.
:func:`attention_lse_ref` adds the row logsumexp the training forward
saves, and :func:`attention_bwd_ref` is the plain backward
(``csrc/flash_attention_bwd.cu``'s), which the CPU's training path runs;
:func:`attention_bwd_bf16_ref`, for tests, repeats the bfloat16 kernels'
roundings of P and dS.
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
    scores = masked_scores(q, k, causal=causal, window=window)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)


def seen(s: int, *, causal: bool, window: Optional[int],
         device) -> torch.Tensor:
    """(S, S) bool: key j is seen by query i (``j <= i`` if causal, ``j >
    i - window`` with a window)."""
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def masked_scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                  window: Optional[int]) -> torch.Tensor:
    """float32 scores ``(q . k) / sqrt(float32(dh))`` of q, k (..., S, dh),
    NEG where the key is not seen."""
    s, dh = q.shape[-2], q.shape[-1]
    scores = (q.float() @ k.float().transpose(-1, -2)) * inv_sqrt(dh)
    mask = seen(s, causal=causal, window=window, device=q.device)
    return torch.where(mask, scores, NEG)


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


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None):
    """:func:`attention_ref` and each row's logsumexp of its scaled, masked
    scores, ``(out (B, S, H, dh) in q's dtype, lse (B, H, S) float32)``:
    the plain version of the forward kernel with ``with_lse``."""
    h = q.shape[2]
    scores = masked_scores(q.transpose(1, 2), repeat_kv(k, h).transpose(1, 2),
                           causal=causal, window=window)
    probs = torch.softmax(scores, dim=-1)
    out = probs @ repeat_kv(v, h).transpose(1, 2).float()
    return (out.to(q.dtype).transpose(1, 2),
            torch.logsumexp(scores, dim=-1))


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None):
    """The plain version of ``csrc/flash_attention_bwd.cu``, with its
    signature: the gradients ``(dq (B, S, H, dh), dk, dv (B, S, KV, dh))``
    in q's dtype from q, k, v, the output ``o``, its gradient ``do`` and
    the forward's ``lse`` (B, H, S), all in float32: P = exp(scores - lse)
    (0 where a key is not seen), D = rowsum(do * o), dV = P^T dO, dS = P
    (dO V^T - D), dQ = dS K / sqrt(dh), dK = dS^T Q / sqrt(dh), dK and dV
    summed over each kv head's group of query heads."""
    return _attention_bwd(q, k, v, o, do, lse, causal, window,
                          lambda x: x)


def attention_bwd_bf16_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           do: torch.Tensor, lse: torch.Tensor, *,
                           causal: bool = True,
                           window: Optional[int] = None):
    """What the bfloat16 route of ``csrc/flash_attention_bwd.cu`` (its
    ``mma.sync`` kernels) computes, for tests: :func:`attention_bwd_ref`
    with the tensor cores' operands rounded where the kernels round them.
    P is rounded once to bfloat16 as the operand of dV = P^T dO, and dS =
    P (dP - D), taken from the float32 P, once as the operand of dK and dQ;
    every sum is float32. It shows on the CPU how far those roundings move
    the gradients from the plain version's."""
    return _attention_bwd(q, k, v, o, do, lse, causal, window,
                          lambda x: x.to(torch.bfloat16).float())


def _attention_bwd(q, k, v, o, do, lse, causal, window, operand):
    """The backward of :func:`attention_bwd_ref`, with ``operand`` applied
    to P and dS where they enter the products dV = P^T dO, dQ = dS K and
    dK = dS^T Q."""
    b, s, h, dh = q.shape
    kv = k.shape[2]

    def heads(x):
        return repeat_kv(x, h).transpose(1, 2).float()   # (B, H, S, dh)

    qf, kf, vf = heads(q), heads(k), heads(v)
    of, dof = o.transpose(1, 2).float(), do.transpose(1, 2).float()
    scores = masked_scores(qf, kf, causal=causal, window=window)
    mask = seen(s, causal=causal, window=window, device=q.device)
    p = torch.where(mask, torch.exp(scores - lse[..., None]), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = operand(p * (dof @ vf.transpose(-1, -2) - delta))
    scale = inv_sqrt(dh)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = operand(p).transpose(-1, -2) @ dof

    def group(x):      # (B, H, S, dh) -> (B, S, KV, dh), the group summed
        return x.reshape(b, kv, h // kv, s, dh).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), group(dk).to(k.dtype),
            group(dv).to(v.dtype))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: half of the dropped
    13 bits' range added to the magnitude bits, then the 13 bits
    cleared. Finite inputs only."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in split TF32: each operand as hi = tf32(x) and lo =
    tf32(x - hi); lo·hi + hi·lo + hi·hi, the small terms first, lo·lo
    dropped. Products of TF32 values are exact in float32, so only the
    order of the float32 sums differs from the tensor cores'."""
    a_hi = round_tf32(a)
    a_lo = round_tf32(a - a_hi)
    b_hi = round_tf32(b)
    b_lo = round_tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def attention_split_tf32_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None) -> torch.Tensor:
    """What ``csrc/flash_attention.cu``'s float32 kernel computes, for
    tests: float32 q (B, S, H, dh), k, v (B, S, KV, dh); S = Q K^T and O +=
    P V in split TF32 (:func:`_split_product`), the online softmax over kv
    tiles of 64 keys (32 at dh=256, ``TF<DH>::kBK``) in the kernel's order (per tile m
    = max(m, max s), alpha = exp(m_old - m), l = alpha l + sum p, O =
    alpha O + P V; at the end O / max(l, 1e-30)), masked scores NEG. It
    shows on the CPU how far split TF32 moves the output from
    :func:`attention_ref`. Returns (B, S, H, dh) float32."""
    b, s, h, dh = q.shape
    k, v = repeat_kv(k, h), repeat_kv(v, h)

    def fold(x):
        return x.float().transpose(1, 2).reshape(b * h, s, dh)

    qf, kf, vf = fold(q), fold(k), fold(v)
    rows = torch.arange(s)[:, None]
    m = torch.full((b * h, s, 1), NEG)
    l = torch.zeros((b * h, s, 1))
    acc = torch.zeros((b * h, s, dh))
    tile = 32 if dh == 256 else 64
    for c0 in range(0, s, tile):
        c1 = min(c0 + tile, s)
        cols = torch.arange(c0, c1)[None, :]
        keep = torch.ones((s, c1 - c0), dtype=torch.bool)
        if causal:
            keep &= cols <= rows
        if window is not None:
            keep &= cols > rows - window
        scores = _split_product(qf, kf[:, c0:c1].transpose(1, 2)) \
            * inv_sqrt(dh)
        scores = torch.where(keep[None], scores, NEG)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + _split_product(p, vf[:, c0:c1])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, s, dh).transpose(1, 2)
