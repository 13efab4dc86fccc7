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

Training differentiates a chunk's scan with :class:`SelectiveScan`, an
autograd Function whose forward is the prefill's scan (the same slices,
the same bits) and which saves only its (B, T, d_in)- and (B, T,
N)-sized inputs. Its backward recomputes each channel slice's ``a_bar``,
``bx`` and states and runs the adjoint recurrence ``lam_t = g_t + a_{t+1}
lam_{t+1}`` by the same doubling steps backwards in time: autograd of the
doubling steps themselves would hold each step's operands, tens of GiB a
layer at jamba's width (the reference recomputes too:
``jax.checkpoint(nothing_saveable)`` around each chunk).

Parameters are held in the dtype the reference reads them at: the matmul
weights, ``conv_w`` and ``d_skip`` in bfloat16 (its ``cdt`` and
``astype(x.dtype)``); ``a_log``, ``dt_bias`` and ``conv_b`` in float32.
Training holds float32 masters of all of them, and every use site casts
with :func:`~repro_torch.models.layers.cdt` to the dtype the reference
computes in (a no-op on the serving weights).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import COMPUTE_DTYPE, cdt, silu, softplus
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
    LOGICAL = {"w_in": ("embed", "inner"), "conv_w": ("conv", "inner"),
               "conv_b": ("inner",), "x_proj": ("inner", None),
               "dt_w": (None, "inner"), "dt_bias": ("inner",),
               "a_log": ("inner", "state"), "d_skip": ("inner",),
               "w_out": ("inner", "embed")}

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
    x_dbl = x_c @ cdt(p.x_proj, x_c.dtype)
    dt, b_mat, c_mat = torch.split(x_dbl, [dt_rank, n, n], dim=-1)
    dt = softplus((dt @ cdt(p.dt_w, x_c.dtype)).float() + p.dt_bias.float())
    return dt, b_mat, c_mat


def discretise(a_log, dt, b_mat, x_c):
    """``(a_bar, bx)`` (B, T, C, N) in dt's dtype (float32) for the C
    channels of ``a_log`` (C, N), ``dt`` and ``x_c`` (B, T, C):
    ``exp(dt * A)`` and ``dt * B * x``."""
    a = -torch.exp(a_log)                                       # (C, N)
    dt = dt[..., None]
    a_bar = torch.exp(dt * a)
    bx = dt * b_mat[:, :, None, :].to(dt.dtype) \
        * x_c[..., None].to(dt.dtype)
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


def reverse_scan_(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The scan backwards in time, in place: ``g`` becomes ``lam_t = g_t +
    a_t * lam_{t+1}`` (``lam`` past the end 0), by the same doubling
    steps; ``a`` is overwritten."""
    t, step = a.shape[1], 1
    while step < t:
        g[:, :-step] += a[:, :-step] * g[:, step:]
        a[:, :-step] = a[:, :-step] * a[:, step:]
        step *= 2
    return g


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


def selective_scan(dt, b_mat, c_mat, x_c, a_log, h_in):
    """One chunk's scan, channel slice by channel slice: ``(y (B, T,
    d_in) in x_c's dtype, h_last (B, d_in, N))``, ``y_t`` the C
    contraction of the bfloat16-rounded state ``h_t`` (before ``d_skip``
    and the gate), from the carried state ``h_in``."""
    b, t, d_in = x_c.shape
    y = torch.empty_like(x_c)
    h_last = torch.empty_like(h_in)
    for ch in channel_slices(b, t, d_in, a_log.shape[1]):
        a_cum, hs = linear_scan_(*discretise(a_log[ch], dt[..., ch], b_mat,
                                             x_c[..., ch]))
        hs += a_cum.mul_(h_in[:, None, ch])                  # (B, T, C, N)
        del a_cum
        h_last[:, ch] = hs[:, -1]
        y[..., ch] = (hs.to(x_c.dtype) @ c_mat[..., None])[..., 0]
        del hs
    return y, h_last


class SelectiveScan(torch.autograd.Function):
    """:func:`selective_scan` under autograd. The forward saves its inputs
    only; the backward, a channel slice at a time, recomputes ``a_bar``,
    ``bx`` and the states ``h``, forms ``g_t = dL/dh_t`` from the C
    contraction (and ``h_last``'s gradient), runs the adjoint recurrence
    ``lam_t = g_t + a_{t+1} lam_{t+1}`` (:func:`reverse_scan_`), and
    chains ``dbx = lam``, ``da_bar_t = lam_t h_{t-1}`` through
    :func:`discretise` with autograd; ``dh_in = a_1 lam_1``. ``b_mat``'s
    and ``x_c``'s gradients add in float32 and are rounded once, as the
    reference's float32 casts of them are."""

    @staticmethod
    def forward(ctx, dt, b_mat, c_mat, x_c, a_log, h_in):
        ctx.save_for_backward(dt, b_mat, c_mat, x_c, a_log, h_in)
        return selective_scan(dt, b_mat, c_mat, x_c, a_log, h_in)

    @staticmethod
    def backward(ctx, gy, gh):
        dt, b_mat, c_mat, x_c, a_log, h_in = ctx.saved_tensors
        b, t, d_in = x_c.shape
        work = dt.dtype
        d_dt, d_x = torch.empty_like(dt), torch.empty_like(x_c)
        d_alog, d_hin = torch.empty_like(a_log), torch.empty_like(h_in)
        d_c = torch.zeros(c_mat.shape, dtype=work, device=c_mat.device)
        b_leaf = b_mat.to(work).detach().requires_grad_()
        d_b = torch.zeros_like(b_leaf)
        for ch in channel_slices(b, t, d_in, a_log.shape[1]):
            leaves = (dt[..., ch].detach().requires_grad_(),
                      x_c[..., ch].to(work).detach().requires_grad_(),
                      a_log[ch].detach().requires_grad_(), b_leaf)
            with torch.enable_grad():
                a_bar, bx = discretise(leaves[2], leaves[0], b_leaf,
                                       leaves[1])
            a_cum, hs = linear_scan_(a_bar.detach().clone(),
                                     bx.detach().clone())
            hs += a_cum.mul_(h_in[:, None, ch])              # (B, T, C, N)
            del a_cum
            g_y = gy[..., ch, None]
            d_c += (g_y.to(work) * hs.to(x_c.dtype).to(work)).sum(2)
            lam = (g_y * c_mat[:, :, None, :]).to(work)      # dL/dh_t
            if gh is not None:
                lam[:, -1] += gh[:, ch]
            a_next = torch.empty_like(hs)
            a_next[:, :-1] = a_bar[:, 1:]
            a_next[:, -1] = 0
            lam = reverse_scan_(a_next, lam)
            del a_next
            d_hin[:, ch] = a_bar[:, 0] * lam[:, 0]
            d_abar = lam * hs.roll(1, dims=1)                # lam_t h_{t-1}
            del hs
            d_abar[:, 0] = lam[:, 0] * h_in[:, ch]
            g_dt, g_x, g_alog, g_b = torch.autograd.grad(
                (a_bar, bx), leaves, (d_abar, lam))
            del a_bar, bx, d_abar, lam
            d_dt[..., ch], d_x[..., ch], d_alog[ch] = g_dt, g_x, g_alog
            d_b += g_b
        return (d_dt, d_b.to(b_mat.dtype), d_c.to(c_mat.dtype), d_x,
                d_alog, d_hin)


def mamba_apply(p: Mamba, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False):
    """Full-sequence form, prefill and train. x (B, S, d) -> ``(out (B, S,
    d), MambaState or None)``."""
    b, s, _ = x.shape
    d_in, _, n, k = dims(cfg)
    x_in, z = torch.chunk(x @ cdt(p.w_in, x.dtype), 2, dim=-1)
    x_c = silu(conv1d_causal(x_in, cdt(p.conv_w, x.dtype), p.conv_b))
    chunk = pick_chunk(s)
    h = torch.zeros((b, d_in, n), dtype=torch.float32, device=x.device)
    a_log, d_skip = p.a_log.float(), cdt(p.d_skip, x.dtype)
    ys = []
    for lo in range(0, s, chunk):
        xc_c, z_c = x_c[:, lo:lo + chunk], z[:, lo:lo + chunk]
        dt, b_mat, c_mat = ssm_inputs(p, xc_c, cfg)
        y, h = SelectiveScan.apply(dt, b_mat, c_mat, xc_c, a_log, h)
        y = y + d_skip * xc_c
        ys.append(y * silu(z_c))
    y = torch.cat(ys, dim=1)
    out = y @ cdt(p.w_out, x.dtype)
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
    x_in, z = torch.chunk(x @ cdt(p.w_in, x.dtype), 2, dim=-1)
    win = torch.cat([state.conv.to(x.dtype), x_in], dim=1)        # (B, k, C)
    x_c = (win.float() * cdt(p.conv_w, x.dtype).float()).sum(1).to(x.dtype)
    x_c = silu(x_c + p.conv_b.to(x.dtype))[:, None, :]
    dt, b_mat, c_mat = ssm_inputs(p, x_c, cfg)
    a_bar, bx = discretise(p.a_log.float(), dt, b_mat, x_c)
    h = a_bar[:, 0] * state.ssm + bx[:, 0]                     # (B, C, N)
    y = (h.to(x.dtype) @ c_mat[:, 0, :, None])[..., 0]
    y = y + cdt(p.d_skip, x.dtype) * x_c[:, 0]
    y = (y * silu(z[:, 0]))[:, None, :]
    new_state = MambaState(
        ssm=h, conv=torch.cat([state.conv[:, 1:], x_in.float()], dim=1))
    return y @ cdt(p.w_out, x.dtype), new_state
