"""Shared layers (port of ``repro.models.layers``): RMSNorm, the rotary
embedding, the gated MLP, the embedding and the output head, and the
activations the mixers share (``jax.nn``'s formulations).

The reference keeps float32 masters and casts each matmul weight to the
compute dtype (bfloat16) at use (``cdt``). Serving holds those weights in
bfloat16 already, which gives the same values, and :func:`cdt` leaves
them as they are; training holds float32 masters (``param_dtype=`` of
:func:`repro_torch.models.new_model`) and every use site casts them with
:func:`cdt`, so their gradients reach the masters in float32. Norm scales
stay float32, as :func:`rmsnorm` reads them. :func:`softmax_xent` is the
training loss.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models import runtime
from repro_torch.models.spec import new_param

COMPUTE_DTYPE = torch.bfloat16


def cdt(x: torch.Tensor, dtype: torch.dtype = COMPUTE_DTYPE) -> torch.Tensor:
    """A (float32 master) weight cast to the compute dtype; the tensor
    itself when it is already held in it."""
    return x.to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm

class RMSNorm(nn.Module):
    INIT = {"scale": "ones"}
    LOGICAL = {"scale": (None,)}

    def __init__(self, dim: int, device: torch.device):
        super().__init__()
        self.scale = new_param((dim,), torch.float32, device)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in float32, the result in x's dtype. Also
    the QK-norm (``rmsnorm_head``), with a (dh,) scale."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


rmsnorm_head = rmsnorm


# ---------------------------------------------------------------------------
# Rotary position embedding (half-rotation / NeoX convention)

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions broadcastable to (..., S). Float32
    angles and rotation, the result in x's dtype."""
    dh = x.shape[-1]
    half = dh // 2
    exponent = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(theta, exponent)              # float32, as theta ** e
    angles = positions[..., None].float() * freqs            # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)

class MLP(nn.Module):
    LOGICAL = {"wi_gate": ("embed", "ff"), "wi_up": ("embed", "ff"),
               "wo": ("ff", "embed")}

    def __init__(self, d_model: int, d_ff: int, device: torch.device):
        super().__init__()
        self.wi_gate = new_param((d_model, d_ff), COMPUTE_DTYPE, device)
        self.wi_up = new_param((d_model, d_ff), COMPUTE_DTYPE, device)
        self.wo = new_param((d_ff, d_model), COMPUTE_DTYPE, device)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each
    op rounded to x's dtype: the reference's ``jax.nn.silu`` on bfloat16,
    which XLA expands so (``F.silu`` rounds once and differs in a third of
    the bfloat16 results)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` op by op in x's dtype:
    ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3)))``, the
    constants rounded to x's dtype as jax rounds them."""
    c, a = (float(torch.tensor(v).to(x.dtype))
            for v in (math.sqrt(2 / math.pi), 0.044715))
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x))))
    return x * cdf


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` (``F.softplus`` switches
    to ``x`` above a threshold and differs in the last bit)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x @ wi_gate) * (x @ wi_up)) @ wo``, in x's dtype."""
    def w(name):
        return runtime.gather_weight(cdt(getattr(p, name), x.dtype),
                                     MLP.LOGICAL[name])
    gate = x @ w("wi_gate")
    up = x @ w("wi_up")
    return (silu(gate) * up) @ w("wo")


# ---------------------------------------------------------------------------
# Embedding + (untied) output head

class Embedding(nn.Module):
    INIT = {"table": "embed"}
    LOGICAL = {"table": ("vocab", "embed")}

    def __init__(self, vocab: int, d_model: int, device: torch.device):
        super().__init__()
        self.table = new_param((vocab, d_model), COMPUTE_DTYPE, device)


class Unembed(nn.Module):
    LOGICAL = {"table": ("vocab", "embed")}

    def __init__(self, vocab: int, d_model: int, device: torch.device):
        super().__init__()
        self.table = new_param((vocab, d_model), COMPUTE_DTYPE, device)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The rows of ``table`` cast to ``dtype`` (the reference's
    ``cdt(table)[tokens]``; the table's own dtype by default)."""
    return cdt(table, dtype or table.dtype)[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits ``x @ table.T`` in x's dtype: (B, S, d) -> (B, S, V); the
    output head's compute-time layout named (``runtime.gather_weight``)."""
    w = runtime.gather_weight(cdt(table, x.dtype), Unembed.LOGICAL["table"])
    return x @ w.T


# ---------------------------------------------------------------------------
# Cross-entropy over (possibly padded) logits

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 true_vocab: int):
    """Mean cross-entropy over the labels ``>= 0`` (``repro``'s
    ``softmax_xent``): logits (B, S, V_pad) of any float dtype taken in
    float32, the pad columns ``>= true_vocab`` set to ``-1e30``, logsumexp
    minus the gold logit. Returns ``(loss, n_tokens)``, both float32
    scalars."""
    vpad = logits.shape[-1]
    lf = logits.float()
    if vpad != true_vocab:
        pad = torch.arange(vpad, device=lf.device) >= true_vocab
        lf = torch.where(pad, -1e30, lf)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    n_tokens = mask.sum()
    loss = ((lse - gold) * mask).sum() / torch.clamp(n_tokens, min=1.0)
    return loss, n_tokens
