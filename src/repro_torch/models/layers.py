"""Shared layers (port of ``repro.models.layers``): RMSNorm, the rotary
embedding, the gated MLP, the embedding and the output head, and the
activations the mixers share (``jax.nn``'s formulations).

The reference keeps float32 masters and casts each matmul weight to the
compute dtype (bfloat16) at use (``cdt``). Serving holds those weights in
bfloat16 already, which gives the same values; norm scales stay float32,
as :func:`rmsnorm` reads them. ``softmax_xent`` waits for training.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.spec import new_param

COMPUTE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# RMSNorm

class RMSNorm(nn.Module):
    INIT = {"scale": "ones"}

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
    gate = x @ p.wi_gate
    up = x @ p.wi_up
    return (silu(gate) * up) @ p.wo


# ---------------------------------------------------------------------------
# Embedding + (untied) output head

class Embedding(nn.Module):
    INIT = {"table": "embed"}

    def __init__(self, vocab: int, d_model: int, device: torch.device):
        super().__init__()
        self.table = new_param((vocab, d_model), COMPUTE_DTYPE, device)


class Unembed(nn.Module):
    def __init__(self, vocab: int, d_model: int, device: torch.device):
        super().__init__()
        self.table = new_param((vocab, d_model), COMPUTE_DTYPE, device)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits ``x @ table.T``: (B, S, d) -> (B, S, V)."""
    return x @ table.T
