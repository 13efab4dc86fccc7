"""xLSTM blocks (port of ``repro.models.xlstm``): mLSTM (matrix memory,
parallel) and sLSTM (scalar memory, recurrent).

* mLSTM prefill is the chunked quadratic form (gate-weighted dot products
  over query chunks of ``pick_chunk(S, 256)`` rows, the float32 cumsum of
  the log forget gates and the running-max stabiliser ``m``); decode is
  the O(1) recurrent form on the stabilised state (C, n, m). Prefill's
  final state is the reference's closed form (the telescoped running max).
* sLSTM runs its recurrence over time as a Python loop of one step a token
  (the reference's ``lax.scan``), the four gates' input projections
  hoisted out of the loop and their block-diagonal recurrent products made
  one batched matmul a step. It is followed by the block's own gated FFN.

Both blocks carry their own projections. The matmul weights and
``conv_w`` are held in bfloat16 (the reference's ``cdt``); the gate biases,
``conv_b`` and the norm scales in float32, as the reference reads them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, gelu_tanh, log_sigmoid,
                                       rmsnorm_head, silu)
from repro_torch.models.mamba import conv1d_causal, conv_tail, pick_chunk
from repro_torch.models.spec import new_param

NEG = -2.0 ** 30
CONV = 4                     # the causal conv's width on the q/k path
GATES = ("z", "i", "f", "o")


# ---------------------------------------------------------------------------
# mLSTM

def mlstm_dims(cfg: ArchConfig):
    d_in = int(cfg.xlstm_proj_factor * cfg.d_model)
    h = cfg.n_heads
    return d_in, h, d_in // h


class MLSTM(nn.Module):
    """The reference's ``mlstm_specs``: ``w_up`` (d, 2 d_in), ``conv_w``
    (4, d_in), ``conv_b`` (d_in,), ``w_q``/``w_k``/``w_v`` (d_in, d_in),
    ``w_i``/``w_f`` (d_in, h), ``b_i``/``b_f`` (h,), ``out_norm`` (dh,),
    ``w_down`` (d_in, d)."""
    INIT = {"conv_b": "zeros", "b_i": "zeros", "b_f": "ones",
            "out_norm": "ones"}

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d = cfg.d_model
        d_in, h, dh = mlstm_dims(cfg)
        bf, f32 = COMPUTE_DTYPE, torch.float32
        self.w_up = new_param((d, 2 * d_in), bf, device)
        self.conv_w = new_param((CONV, d_in), bf, device)
        self.conv_b = new_param((d_in,), f32, device)
        self.w_q = new_param((d_in, d_in), bf, device)
        self.w_k = new_param((d_in, d_in), bf, device)
        self.w_v = new_param((d_in, d_in), bf, device)
        self.w_i = new_param((d_in, h), bf, device)
        self.b_i = new_param((h,), f32, device)
        self.w_f = new_param((d_in, h), bf, device)
        self.b_f = new_param((h,), f32, device)
        self.out_norm = new_param((dh,), f32, device)
        self.w_down = new_param((d_in, d), bf, device)


class MLSTMState(NamedTuple):
    c: torch.Tensor       # (B, H, dh, dh) float32
    n: torch.Tensor       # (B, H, dh) float32
    m: torch.Tensor       # (B, H) float32
    conv: torch.Tensor    # (B, 3, d_in) float32


def init_mlstm_state(cfg: ArchConfig, batch: int,
                     device: torch.device) -> MLSTMState:
    d_in, h, dh = mlstm_dims(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return MLSTMState(c=zeros(batch, h, dh, dh), n=zeros(batch, h, dh),
                      m=zeros(batch, h), conv=zeros(batch, CONV - 1, d_in))


def _key_scale(dh: int, dtype: torch.dtype) -> float:
    """``sqrt(dh)`` as jax's weak-typed scalar meets a bfloat16 array:
    rounded to that dtype."""
    return float(torch.tensor(math.sqrt(dh)).to(dtype))


def _gates(p: MLSTM, x_conv: torch.Tensor):
    """Input and log forget gate pre-activations, float32 (..., h)."""
    i_pre = (x_conv @ p.w_i).float() + p.b_i
    log_f = log_sigmoid((x_conv @ p.w_f).float() + p.b_f)
    return i_pre, log_f


def mlstm_apply(p: MLSTM, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False):
    """Full-sequence mLSTM block. x (B, S, d) (pre-normed) -> ``(out,
    MLSTMState or None)``."""
    b, s, _ = x.shape
    d_in, h, dh = mlstm_dims(cfg)
    x_m, z = torch.chunk(x @ p.w_up, 2, dim=-1)
    x_conv = silu(conv1d_causal(x_m, p.conv_w, p.conv_b))
    # (B, H, S, dh) heads first for the matmuls
    q = (x_conv @ p.w_q).view(b, s, h, dh).transpose(1, 2)
    k = ((x_conv @ p.w_k).view(b, s, h, dh)
         / _key_scale(dh, x.dtype)).transpose(1, 2)
    v = (x_m @ p.w_v).view(b, s, h, dh).transpose(1, 2)
    i_pre, log_f = (g.transpose(1, 2) for g in _gates(p, x_conv))  # (B,H,S)
    f_cum = torch.cumsum(log_f, dim=-1)

    chunk = pick_chunk(s, 256)
    cols = torch.arange(s, device=x.device)
    ctx = []
    for r0 in range(0, s, chunk):
        f_t = f_cum[..., r0:r0 + chunk]
        dmat = (f_t[..., :, None] - f_cum[..., None, :]
                + i_pre[..., None, :])                       # (B,H,T,S)
        rows = r0 + torch.arange(chunk, device=x.device)
        dmat = torch.where(cols[None, :] <= rows[:, None], dmat, NEG)
        m = dmat.amax(dim=-1)                                # (B,H,T)
        wsc = (q[:, :, r0:r0 + chunk] @ k.transpose(-1, -2)).float() \
            * torch.exp(dmat - m[..., None])
        del dmat
        denom = torch.clamp(torch.maximum(wsc.sum(-1).abs(), torch.exp(-m)),
                            min=1e-6)
        ctx.append(wsc.to(x.dtype) @ v
                   / denom[..., None].to(x.dtype))
        del wsc
    ctx = torch.cat(ctx, dim=2).transpose(1, 2)              # (B,S,H,dh)
    ctx = rmsnorm_head(p.out_norm, ctx, cfg.norm_eps)
    out = (ctx.reshape(b, s, d_in) * silu(z)) @ p.w_down
    if not return_state:
        return out, None
    # the final recurrent state in closed form (telescoped running max)
    wexp = f_cum[..., -1:] - f_cum + i_pre                   # (B,H,S)
    m_fin = wexp.amax(dim=-1)
    wgt = torch.exp(wexp - m_fin[..., None])
    kf = k.float() * wgt[..., None]
    c_fin = kf.transpose(-1, -2) @ v.float()                 # (B,H,dh,dh)
    n_fin = kf.sum(dim=2)
    return out, MLSTMState(c=c_fin, n=n_fin, m=m_fin,
                           conv=conv_tail(x_m, CONV))


def mlstm_step(p: MLSTM, x: torch.Tensor, cfg: ArchConfig,
               state: MLSTMState):
    """One-token recurrent mLSTM. x (B, 1, d) -> ``(out, new state)``."""
    b = x.shape[0]
    d_in, h, dh = mlstm_dims(cfg)
    x_m, z = torch.chunk(x @ p.w_up, 2, dim=-1)
    win = torch.cat([state.conv.to(x.dtype), x_m], dim=1)        # (B, 4, C)
    x_conv = (win.float() * p.conv_w.float()).sum(1).to(x.dtype)
    x_conv = silu(x_conv + p.conv_b.to(x.dtype))
    q = (x_conv @ p.w_q).view(b, h, dh).float()
    k = ((x_conv @ p.w_k).view(b, h, dh)
         / _key_scale(dh, x.dtype)).float()
    v = (x_m[:, 0] @ p.w_v).view(b, h, dh).float()
    i_t, f_t = _gates(p, x_conv)                                 # (B, H)

    m_new = torch.maximum(f_t + state.m, i_t)
    decay = torch.exp(f_t + state.m - m_new)
    inject = torch.exp(i_t - m_new)
    c_new = decay[..., None, None] * state.c \
        + inject[..., None, None] * (k[..., :, None] * v[..., None, :])
    n_new = decay[..., None] * state.n + inject[..., None] * k
    num = (q[..., None, :] @ c_new)[..., 0, :]                   # (B, H, dh)
    den = torch.clamp(torch.maximum((q * n_new).sum(-1).abs(),
                                    torch.exp(-m_new)), min=1e-6)
    ctx = (num / den[..., None]).to(x.dtype)
    ctx = rmsnorm_head(p.out_norm, ctx, cfg.norm_eps)
    out = (ctx.reshape(b, 1, d_in) * silu(z)) @ p.w_down
    conv = torch.cat([state.conv[:, 1:], x_m.float()], dim=1)
    return out, MLSTMState(c=c_new, n=n_new, m=m_new, conv=conv)


# ---------------------------------------------------------------------------
# sLSTM

def slstm_dims(cfg: ArchConfig):
    h = cfg.n_heads
    ff = int(cfg.xlstm_slstm_proj * cfg.d_model)
    return h, cfg.d_model // h, ((ff + 63) // 64) * 64


class SLSTM(nn.Module):
    """The reference's ``slstm_specs``: per gate g in z, i, f, o ``w_g``
    (d, h, dh), ``r_g`` (h, dh, dh) (std 0.5 / sqrt(h)) and ``b_g``
    (h, dh) (ones for f); ``out_norm`` (dh,); the FFN's ``ff_up``
    (d, 2 ff), ``ff_down`` (ff, d) and ``ff_norm`` (d,), which the
    reference declares and its block never reads (``ln_ff`` norms the
    FFN's input)."""
    INIT = {"b_z": "zeros", "b_i": "zeros", "b_f": "ones", "b_o": "zeros",
            "out_norm": "ones", "ff_norm": "ones"}
    SCALE = {f"r_{g}": 0.5 for g in GATES}

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d = cfg.d_model
        h, dh, ff = slstm_dims(cfg)
        bf, f32 = COMPUTE_DTYPE, torch.float32
        for g in GATES:
            setattr(self, f"w_{g}", new_param((d, h, dh), bf, device))
            setattr(self, f"r_{g}", new_param((h, dh, dh), bf, device))
            setattr(self, f"b_{g}", new_param((h, dh), f32, device))
        self.out_norm = new_param((dh,), f32, device)
        self.ff_up = new_param((d, 2 * ff), bf, device)
        self.ff_down = new_param((ff, d), bf, device)
        self.ff_norm = new_param((d,), f32, device)


class SLSTMState(NamedTuple):
    c: torch.Tensor       # (B, H, dh) float32
    n: torch.Tensor       # (B, H, dh)
    hid: torch.Tensor     # (B, H, dh)
    m: torch.Tensor       # (B, H, dh)


def init_slstm_state(cfg: ArchConfig, batch: int,
                     device: torch.device) -> SLSTMState:
    h, dh, _ = slstm_dims(cfg)
    return SLSTMState(*(torch.zeros((batch, h, dh), dtype=torch.float32,
                                    device=device) for _ in range(4)))


def _slstm_inputs(p: SLSTM, x: torch.Tensor) -> torch.Tensor:
    """The four gates' input projections plus biases, float32
    (B, S, 4, H, dh) in the order z, i, f, o."""
    d, h, dh = p.w_z.shape
    w = torch.stack([getattr(p, f"w_{g}") for g in GATES], dim=1)
    wx = (x @ w.reshape(d, 4 * h * dh)).float()
    bias = torch.stack([getattr(p, f"b_{g}") for g in GATES])
    return wx.unflatten(-1, (4, h, dh)) + bias


def _slstm_cell(r: torch.Tensor, state: SLSTMState, wx: torch.Tensor,
                dtype: torch.dtype) -> SLSTMState:
    """One step. ``r`` (H, dh, 4 dh) the recurrent weights of the four
    gates side by side; ``wx`` (B, 4, H, dh)."""
    hid = state.hid.to(dtype).transpose(0, 1)                   # (H, B, dh)
    rec = (hid @ r).float().unflatten(-1, (4, -1))              # (H,B,4,dh)
    pre = wx + rec.permute(1, 2, 0, 3)                          # (B,4,H,dh)
    z = torch.tanh(pre[:, 0])
    i_log = pre[:, 1]
    f_log = log_sigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(f_log + state.m, i_log)
    i_p = torch.exp(i_log - m_new)
    f_p = torch.exp(f_log + state.m - m_new)
    c = f_p * state.c + i_p * z
    n = f_p * state.n + i_p
    return SLSTMState(c=c, n=n, hid=o * c / torch.clamp(n, min=1e-6),
                      m=m_new)


def _recurrent(p: SLSTM) -> torch.Tensor:
    return torch.cat([getattr(p, f"r_{g}") for g in GATES], dim=-1)


def slstm_apply(p: SLSTM, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False):
    """Full-sequence sLSTM (pre-normed x (B, S, d)) -> ``(y (B, S, d),
    SLSTMState or None)``; the caller adds the FFN (:func:`slstm_ffn`)."""
    b, s, d = x.shape
    wx = _slstm_inputs(p, x)
    r = _recurrent(p)
    state = init_slstm_state(cfg, b, x.device)
    hids = []
    for t in range(s):
        state = _slstm_cell(r, state, wx[:, t], x.dtype)
        hids.append(state.hid)
    hid = torch.stack(hids, dim=1).to(x.dtype)                   # (B,S,H,dh)
    y = rmsnorm_head(p.out_norm, hid, cfg.norm_eps).reshape(b, s, d)
    return y, (state if return_state else None)


def slstm_ffn(p: SLSTM, x: torch.Tensor) -> torch.Tensor:
    """The sLSTM block's gated FFN (pre-normed input): GeGLU with the tanh
    GELU."""
    g, u = torch.chunk(x @ p.ff_up, 2, dim=-1)
    return (gelu_tanh(g) * u) @ p.ff_down


def slstm_step(p: SLSTM, x: torch.Tensor, cfg: ArchConfig,
               state: SLSTMState):
    """One-token sLSTM. x (B, 1, d) -> ``(y (B, 1, d), new state)``."""
    b, _, d = x.shape
    new = _slstm_cell(_recurrent(p), state, _slstm_inputs(p, x)[:, 0],
                      x.dtype)
    hid = rmsnorm_head(p.out_norm, new.hid.to(x.dtype)[:, None], cfg.norm_eps)
    return hid.reshape(b, 1, d), new
