"""Mamba (S6) mixer (port of ``repro.models.mamba``): the chunked parallel
form for prefill, the O(1) recurrent form for decode.

Prefill keeps the reference's chunks along the sequence (``pick_chunk``,
1,024 rows), so the carried SSM state crosses a chunk where the
reference's does. Inside a chunk the linear recurrence
``h_t = a_bar_t * h_{t-1} + bx_t`` runs in float32 as log2(T) doubling
steps (the reference's ``lax.associative_scan`` adds in another order, so
the two agree to float32 rounding, not bit for bit). The only bfloat16
rounding of the state is the reference's: ``h`` before the C contraction.

A chunk's (B, T, d_in, N) float32 tensors are large at full width (4.3
GB each for jamba's d_in = 8,192 at B = 8, T = 1,024), and the doubling
steps hold several at once, so a chunk runs over slices of the d_in
channels (:data:`SCAN_ELEMENTS` elements a tensor). The channels are
independent, so the slicing changes no number.

Parameters are held in the dtype the reference reads them at: the matmul
weights, ``conv_w`` and ``d_skip`` in bfloat16 (its ``cdt`` and
``astype(x.dtype)``); ``a_log``, ``dt_bias`` and ``conv_b`` in float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import COMPUTE_DTYPE, silu, softplus
from repro_torch.models.spec import new_param

SCAN_ELEMENTS = 1 << 28      # a (B, T, d_in slice, N) float32 tensor: 1 GiB


def dims(cfg: ArchConfig):
    d_in = cfg.mamba_expand * cfg.d_model
    dt_rank = max(cfg.d_model // 16, 1)
    return d_in, dt_rank, cfg.mamba_d_state, cfg.mamba_d_conv


class Mamba(nn.Module):
    """The reference's ``mamba_specs``: ``w_in`` (d, 2 d_in), ``conv_w``
    (k, d_in), ``conv_b`` (d_in,), ``x_proj`` (d_in, dt_rank + 2N),
    ``dt_w`` (dt_rank, d_in), ``dt_bias`` (d_in,), ``a_log`` (d_in, N),
    ``d_skip`` (d_in,), ``w_out`` (d_in, d)."""
    INIT = {"conv_b": "zeros", "dt_bias": "ones", "a_log": "ones",
            "d_skip": "ones"}

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d = cfg.d_model
        d_in, dt_rank, n, k = dims(cfg)
        bf, f32 = COMPUTE_DTYPE, torch.float32
        self.w_in = new_param((d, 2 * d_in), bf, device)
        self.conv_w = new_param((k, d_in), bf, device)
        self.conv_b = new_param((d_in,), f32, device)
        self.x_proj = new_param((d_in, dt_rank + 2 * n), bf, device)
        self.dt_w = new_param((dt_rank, d_in), bf, device)
        self.dt_bias = new_param((d_in,), f32, device)
        self.a_log = new_param((d_in, n), f32, device)
        self.d_skip = new_param((d_in,), bf, device)
        self.w_out = new_param((d_in, d), bf, device)


class MambaState(NamedTuple):
    ssm: torch.Tensor     # (B, d_in, N) float32
    conv: torch.Tensor    # (B, k-1, d_in) float32: trailing conv inputs


def init_state(cfg: ArchConfig, batch: int,
               device: torch.device) -> MambaState:
    d_in, _, n, k = dims(cfg)
    return MambaState(
        ssm=torch.zeros((batch, d_in, n), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, k - 1, d_in), dtype=torch.float32,
                         device=device))


def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B, S, C), w (k, C), b (C,): each output
    the float32 sum of its k taps rounded to x's dtype, then the bias
    added in x's dtype (as the decode step's ``einsum`` and add)."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    acc = xp[:, 0:s].float() * w[0].float()
    for j in range(1, k):
        acc = acc + xp[:, j:j + s].float() * w[j].float()
    return acc.to(x.dtype) + b.to(x.dtype)


def ssm_inputs(p: Mamba, x_c: torch.Tensor, cfg: ArchConfig):
    """``x_c`` (B, T, d_in) -> ``(dt (B, T, d_in) float32, b_mat and c_mat
    (B, T, N) in x_c's dtype)``: the discretisation's inputs."""
    _, dt_rank, n, _ = dims(cfg)
    x_dbl = x_c @ p.x_proj
    dt, b_mat, c_mat = torch.split(x_dbl, [dt_rank, n, n], dim=-1)
    dt = softplus((dt @ p.dt_w).float() + p.dt_bias)
    return dt, b_mat, c_mat


def discretise(p: Mamba, dt, b_mat, x_c, channels: slice):
    """``(a_bar, bx)`` (B, T, C, N) float32 for the ``channels`` slice:
    ``exp(dt * A)`` and ``dt * B * x``."""
    a = -torch.exp(p.a_log[channels])                           # (C, N)
    dt = dt[..., channels, None]
    a_bar = torch.exp(dt * a)
    bx = dt * b_mat[:, :, None, :].float() \
        * x_c[..., channels, None].float()
    return a_bar, bx


def linear_scan_(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` along dim 1 from
    ``h = 0``, in place: ``a`` becomes ``a_1 ... a_t`` and ``b`` becomes
    ``h_t``, for every t, by doubling steps (each right-hand side is
    computed whole before it is written)."""
    t, step = a.shape[1], 1
    while step < t:
        b[:, step:] += a[:, step:] * b[:, :-step]
        a[:, step:] = a[:, step:] * a[:, :-step]
        step *= 2
    return a, b


def pick_chunk(s: int, target: int = 1024) -> int:
    if s <= target:
        return s
    c = target
    while s % c != 0:
        c //= 2
    return max(c, 1)


def channel_slices(b: int, t: int, d_in: int, n: int):
    width = max(1, min(d_in, SCAN_ELEMENTS // max(b * t * n, 1)))
    return [slice(lo, min(lo + width, d_in)) for lo in range(0, d_in, width)]


def mamba_apply(p: Mamba, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False):
    """Full-sequence form. x (B, S, d) -> ``(out (B, S, d), MambaState or
    None)``."""
    b, s, _ = x.shape
    d_in, _, n, k = dims(cfg)
    x_in, z = torch.chunk(x @ p.w_in, 2, dim=-1)
    x_c = silu(conv1d_causal(x_in, p.conv_w, p.conv_b))
    chunk = pick_chunk(s)
    h = torch.zeros((b, d_in, n), dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, s, chunk):
        xc_c, z_c = x_c[:, lo:lo + chunk], z[:, lo:lo + chunk]
        dt, b_mat, c_mat = ssm_inputs(p, xc_c, cfg)
        y = torch.empty_like(xc_c)
        h_next = torch.empty_like(h)
        for ch in channel_slices(b, chunk, d_in, n):
            a_cum, hs = linear_scan_(*discretise(p, dt, b_mat, xc_c, ch))
            hs += a_cum.mul_(h[:, None, ch])                 # (B, T, C, N)
            del a_cum
            h_next[:, ch] = hs[:, -1]
            y[..., ch] = (hs.to(x.dtype) @ c_mat[..., None])[..., 0]
            del hs
        h = h_next
        y = y + p.d_skip * xc_c
        ys.append(y * silu(z_c))
    y = torch.cat(ys, dim=1)
    out = y @ p.w_out
    if not return_state:
        return out, None
    return out, MambaState(ssm=h, conv=conv_tail(x_in, k))


def conv_tail(x_in: torch.Tensor, k: int) -> torch.Tensor:
    """The last k-1 conv inputs (zeros in front of a shorter sequence),
    float32."""
    s = x_in.shape[1]
    if s >= k - 1:
        return x_in[:, s - (k - 1):].float()
    return torch.nn.functional.pad(x_in, (0, 0, k - 1 - s, 0)).float()


def mamba_step(p: Mamba, x: torch.Tensor, cfg: ArchConfig,
               state: MambaState):
    """One-token decode. x (B, 1, d) -> ``(out (B, 1, d), new state)``."""
    x_in, z = torch.chunk(x @ p.w_in, 2, dim=-1)
    win = torch.cat([state.conv.to(x.dtype), x_in], dim=1)        # (B, k, C)
    x_c = (win.float() * p.conv_w.float()).sum(1).to(x.dtype)
    x_c = silu(x_c + p.conv_b.to(x.dtype))[:, None, :]
    dt, b_mat, c_mat = ssm_inputs(p, x_c, cfg)
    a_bar, bx = discretise(p, dt, b_mat, x_c, slice(None))
    h = a_bar[:, 0] * state.ssm + bx[:, 0]                     # (B, C, N)
    y = (h.to(x.dtype) @ c_mat[:, 0, :, None])[..., 0]
    y = y + p.d_skip * x_c[:, 0]
    y = (y * silu(z[:, 0]))[:, None, :]
    new_state = MambaState(
        ssm=h, conv=torch.cat([state.conv[:, 1:], x_in.float()], dim=1))
    return y @ p.w_out, new_state
