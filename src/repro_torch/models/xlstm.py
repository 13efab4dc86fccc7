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

In training the mLSTM runs under autograd as it is (its chunks'
(B, H, T, S) operands held for one block at a time by the per-block
recompute); the sLSTM runs through :class:`SLSTMScan`, whose backward is
written out: autograd of the token loop would record every step's ~25
operations with autograd's host cost. Floors that the reference takes
with ``jnp.maximum`` are ``torch.maximum``, not ``torch.clamp``: at a tie
both split the gradient evenly between the two operands, where
``clamp`` would pass all of it.

Both blocks carry their own projections. The matmul weights and
``conv_w`` are held in bfloat16 (the reference's ``cdt``); the gate biases,
``conv_b`` and the norm scales in float32, as the reference reads them.
Training holds float32 masters of all of them; every use site casts with
:func:`~repro_torch.models.layers.cdt` (a no-op on the serving weights).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, cdt, gelu_tanh,
                                       log_sigmoid, rmsnorm_head, silu)
from repro_torch.models.mamba import conv1d_causal, conv_tail, pick_chunk
from repro_torch.models.spec import new_param

NEG = -2.0 ** 30
CONV = 4                     # the causal conv's width on the q/k path
GATES = ("z", "i", "f", "o")
EPS = 1e-6                   # the normalisers' floor


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
    LOGICAL = {"w_up": ("embed", "inner"), "conv_w": ("conv", "inner"),
               "conv_b": ("inner",), "w_q": (None, "inner"),
               "w_k": (None, "inner"), "w_v": (None, "inner"),
               "w_i": ("inner", "heads"), "b_i": ("heads",),
               "w_f": ("inner", "heads"), "b_f": ("heads",),
               "out_norm": (None,), "w_down": ("inner", "embed")}

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


def _floor(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 1e-6)``, its gradient halved at a tie (the floor
    made on the device: a host scalar would be a synchronising copy)."""
    return torch.maximum(x, x.new_full((), EPS))


def _key_scale(dh: int, dtype: torch.dtype) -> float:
    """``sqrt(dh)`` as jax's weak-typed scalar meets a bfloat16 array:
    rounded to that dtype."""
    return float(torch.tensor(math.sqrt(dh)).to(dtype))


def _gates(p: MLSTM, x_conv: torch.Tensor):
    """Input and log forget gate pre-activations, float32 (..., h)."""
    i_pre = (x_conv @ cdt(p.w_i, x_conv.dtype)).float() + p.b_i.float()
    log_f = log_sigmoid((x_conv @ cdt(p.w_f, x_conv.dtype)).float()
                        + p.b_f.float())
    return i_pre, log_f


def mlstm_apply(p: MLSTM, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False):
    """Full-sequence mLSTM block. x (B, S, d) (pre-normed) -> ``(out,
    MLSTMState or None)``."""
    b, s, _ = x.shape
    d_in, h, dh = mlstm_dims(cfg)
    x_m, z = torch.chunk(x @ cdt(p.w_up, x.dtype), 2, dim=-1)
    x_conv = silu(conv1d_causal(x_m, cdt(p.conv_w, x.dtype), p.conv_b))
    # (B, H, S, dh) heads first for the matmuls
    q = (x_conv @ cdt(p.w_q, x.dtype)).view(b, s, h, dh).transpose(1, 2)
    k = ((x_conv @ cdt(p.w_k, x.dtype)).view(b, s, h, dh)
         / _key_scale(dh, x.dtype)).transpose(1, 2)
    v = (x_m @ cdt(p.w_v, x.dtype)).view(b, s, h, dh).transpose(1, 2)
    i_pre, log_f = (g.transpose(1, 2) for g in _gates(p, x_conv))  # (B,H,S)
    f_cum = torch.cumsum(log_f, dim=-1)
    ctx = mlstm_chunks(q, k, v, i_pre, f_cum).transpose(1, 2)  # (B,S,H,dh)
    ctx = rmsnorm_head(p.out_norm, ctx, cfg.norm_eps)
    out = (ctx.reshape(b, s, d_in) * silu(z)) @ cdt(p.w_down, x.dtype)
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


def mlstm_chunks(q, k, v, i_pre, f_cum) -> torch.Tensor:
    """The mLSTM's parallel form over query chunks of ``pick_chunk(S,
    256)`` rows: ``q``, ``k``, ``v`` (B, H, S, dh) in the compute dtype,
    the input gates ``i_pre`` and cumulative log forget gates ``f_cum``
    (B, H, S) float32 -> the context (B, H, S, dh)."""
    s = q.shape[2]
    chunk = pick_chunk(s, 256)
    cols = torch.arange(s, device=q.device)
    ctx = []
    for r0 in range(0, s, chunk):
        f_t = f_cum[..., r0:r0 + chunk]
        dmat = (f_t[..., :, None] - f_cum[..., None, :]
                + i_pre[..., None, :])                       # (B,H,T,S)
        rows = r0 + torch.arange(chunk, device=q.device)
        dmat = torch.where(cols[None, :] <= rows[:, None], dmat, NEG)
        m = dmat.amax(dim=-1)                                # (B,H,T)
        wsc = (q[:, :, r0:r0 + chunk] @ k.transpose(-1, -2)).float() \
            * torch.exp(dmat - m[..., None])
        del dmat
        denom = _floor(torch.maximum(wsc.sum(-1).abs(), torch.exp(-m)))
        ctx.append(wsc.to(q.dtype) @ v
                   / denom[..., None].to(q.dtype))
        del wsc
    return torch.cat(ctx, dim=2)


def mlstm_step(p: MLSTM, x: torch.Tensor, cfg: ArchConfig,
               state: MLSTMState):
    """One-token recurrent mLSTM. x (B, 1, d) -> ``(out, new state)``."""
    b = x.shape[0]
    d_in, h, dh = mlstm_dims(cfg)
    x_m, z = torch.chunk(x @ cdt(p.w_up, x.dtype), 2, dim=-1)
    win = torch.cat([state.conv.to(x.dtype), x_m], dim=1)        # (B, 4, C)
    x_conv = (win.float() * cdt(p.conv_w, x.dtype).float()).sum(1) \
        .to(x.dtype)
    x_conv = silu(x_conv + p.conv_b.to(x.dtype))
    q = (x_conv @ cdt(p.w_q, x.dtype)).view(b, h, dh).float()
    k = ((x_conv @ cdt(p.w_k, x.dtype)).view(b, h, dh)
         / _key_scale(dh, x.dtype)).float()
    v = (x_m[:, 0] @ cdt(p.w_v, x.dtype)).view(b, h, dh).float()
    i_t, f_t = _gates(p, x_conv)                                 # (B, H)

    m_new = torch.maximum(f_t + state.m, i_t)
    decay = torch.exp(f_t + state.m - m_new)
    inject = torch.exp(i_t - m_new)
    c_new = decay[..., None, None] * state.c \
        + inject[..., None, None] * (k[..., :, None] * v[..., None, :])
    n_new = decay[..., None] * state.n + inject[..., None] * k
    num = (q[..., None, :] @ c_new)[..., 0, :]                   # (B, H, dh)
    den = _floor(torch.maximum((q * n_new).sum(-1).abs(),
                               torch.exp(-m_new)))
    ctx = (num / den[..., None]).to(x.dtype)
    ctx = rmsnorm_head(p.out_norm, ctx, cfg.norm_eps)
    out = (ctx.reshape(b, 1, d_in) * silu(z)) @ cdt(p.w_down, x.dtype)
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
    LOGICAL = {**{f"w_{g}": ("embed", "heads", "head_dim") for g in GATES},
               **{f"r_{g}": ("heads", "head_dim", None) for g in GATES},
               **{f"b_{g}": ("heads", "head_dim") for g in GATES},
               "out_norm": (None,), "ff_up": ("embed", "ff"),
               "ff_down": ("ff", "embed"), "ff_norm": (None,)}

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
    w = torch.stack([cdt(getattr(p, f"w_{g}"), x.dtype) for g in GATES],
                    dim=1)
    wx = (x @ w.reshape(d, 4 * h * dh)).float()
    bias = torch.stack([getattr(p, f"b_{g}").float() for g in GATES])
    return wx.unflatten(-1, (4, h, dh)) + bias


def _slstm_pre(r: torch.Tensor, hid: torch.Tensor, wx: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """A step's gate pre-activations (B, 4, H, dh) in ``wx``'s dtype
    (float32): ``wx`` (B, 4, H, dh) plus the recurrent products of the
    last hidden state ``hid`` (B, H, dh) rounded to ``dtype``; ``r`` (H,
    dh, 4 dh) the recurrent weights of the four gates side by side."""
    hid = hid.to(dtype).transpose(0, 1)                         # (H, B, dh)
    rec = (hid @ r).to(wx.dtype).unflatten(-1, (4, -1))        # (H,B,4,dh)
    return wx + rec.permute(1, 2, 0, 3)


def _slstm_update(pre: torch.Tensor, state: SLSTMState) -> SLSTMState:
    """The state after a step from its pre-activations."""
    z = torch.tanh(pre[:, 0])
    i_log = pre[:, 1]
    f_log = log_sigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(f_log + state.m, i_log)
    i_p = torch.exp(i_log - m_new)
    f_p = torch.exp(f_log + state.m - m_new)
    c = f_p * state.c + i_p * z
    n = f_p * state.n + i_p
    return SLSTMState(c=c, n=n, hid=o * c / _floor(n), m=m_new)


def _slstm_cell(r: torch.Tensor, state: SLSTMState, wx: torch.Tensor,
                dtype: torch.dtype) -> SLSTMState:
    """One step: ``wx`` (B, 4, H, dh)."""
    return _slstm_update(_slstm_pre(r, state.hid, wx, dtype), state)


def _recurrent(p: SLSTM, dtype: torch.dtype) -> torch.Tensor:
    return torch.cat([cdt(getattr(p, f"r_{g}"), dtype) for g in GATES],
                     dim=-1)


def _tie(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The share of ``maximum(a, b)``'s gradient that goes to ``a``: 1, a
    half at a tie, 0."""
    return (a > b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)


class SLSTMScan(torch.autograd.Function):
    """:func:`slstm_scan` under autograd, with a backward written out: the
    forward is the token loop of :func:`_slstm_cell` under ``no_grad``
    (the same bits), keeping each step's pre-activations and state (B, S,
    ...)-sized; the backward computes every gate and local derivative for
    all tokens at once, runs the adjoint of the recurrence as one loop of
    elementwise steps and one recurrent product a token backwards in time,
    and forms ``wx``'s gradient (the pre-activations') and ``r``'s (one
    product over every token) after it. Autograd of the loop would record
    ~100 operations a token, each with autograd's host cost. ``maximum``'s
    gradient splits at a tie, as ``jnp.maximum``'s does."""

    @staticmethod
    def forward(ctx, r, wx, c0, n0, hid0, m0):
        ctx.set_materialize_grads(False)
        state = SLSTMState(c=c0, n=n0, hid=hid0, m=m0)
        pres, states = [], []
        for t in range(wx.shape[1]):
            pre = _slstm_pre(r, state.hid, wx[:, t], r.dtype)
            state = _slstm_update(pre, state)
            pres.append(pre)
            states.append(state)
        hid = torch.stack([st.hid for st in states], dim=1)     # (B,S,H,dh)
        if any(ctx.needs_input_grad):         # not in prefill
            c, n, m = (torch.stack([getattr(st, k) for st in states], dim=1)
                       for k in ("c", "n", "m"))
            ctx.save_for_backward(r, torch.stack(pres, dim=1), c0, n0, hid0,
                                  m0, c, n, hid, m)
        return (hid.to(r.dtype),) + tuple(state)

    @staticmethod
    def backward(ctx, g_y, g_c, g_n, g_hid, g_m):
        r, pre, c0, n0, hid0, m0, c, n, hid, m = ctx.saved_tensors
        dtype = r.dtype
        b, s, _, h, dh = pre.shape

        def before(first, seq):                  # the state before each step
            return torch.cat([first[:, None], seq[:, :-1]], dim=1)

        c_prev, n_prev, m_prev = before(c0, c), before(n0, n), before(m0, m)
        z, i_log = torch.tanh(pre[:, :, 0]), pre[:, :, 1]
        f_log, o = log_sigmoid(pre[:, :, 2]), torch.sigmoid(pre[:, :, 3])
        fm = f_log + m_prev
        i_p, f_p = torch.exp(i_log - m), torch.exp(fm - m)
        to_fm = _tie(fm, i_log)                  # m = maximum(fm, i_log)
        nf = _floor(n)
        a_c = o / nf                             # d hid / d c
        a_n = -(hid / nf) * _tie(n, n.new_full((), EPS))    # d hid / d n
        a_z = i_p * (1 - z * z)                  # d c / d pre_z
        a_f = torch.sigmoid(-pre[:, :, 2])       # d f_log / d pre_f
        a_o = c * (o * (1 - o)) / nf             # d hid / d pre_o
        d_pre = torch.empty_like(pre)
        r_t = r.transpose(-1, -2)                                # (H,4dh,dh)
        zero = torch.zeros_like(c0)
        dout = g_y.to(pre.dtype) if g_y is not None else \
            torch.zeros_like(hid)
        d_hid = g_hid if g_hid is not None else zero
        d_c = g_c if g_c is not None else zero
        d_n = g_n if g_n is not None else zero
        d_m = g_m if g_m is not None else zero
        for t in range(s - 1, -1, -1):
            g = dout[:, t] + d_hid
            dc = d_c + g * a_c[:, t]
            dn = d_n + g * a_n[:, t]
            d_lf = (dc * c_prev[:, t] + dn * n_prev[:, t]) * f_p[:, t]
            d_li = (dc * z[:, t] + dn) * i_p[:, t]
            d_mn = d_m - d_lf - d_li
            d_fm = d_lf + d_mn * to_fm[:, t]
            torch.mul(dc, a_z[:, t], out=d_pre[:, t, 0])
            torch.add(d_li, d_mn * (1 - to_fm[:, t]), out=d_pre[:, t, 1])
            torch.mul(d_fm, a_f[:, t], out=d_pre[:, t, 2])
            torch.mul(g, a_o[:, t], out=d_pre[:, t, 3])
            d_m, d_c, d_n = d_fm, dc * f_p[:, t], dn * f_p[:, t]
            rec = d_pre[:, t].permute(2, 0, 1, 3).reshape(h, b, 4 * dh)
            d_hid = (rec.to(dtype) @ r_t).to(pre.dtype).transpose(0, 1)
        # r's gradient: every step's last hidden state (rounded as the
        # forward rounds it) against its recurrent products' gradient
        hid_prev = before(hid0, hid).to(dtype).permute(2, 3, 0, 1)
        rec = d_pre.permute(3, 0, 1, 2, 4).reshape(h, b * s, 4 * dh)
        d_r = hid_prev.reshape(h, dh, b * s) @ rec.to(dtype)
        grads = [d_r, d_pre, d_c, d_n, d_hid, d_m]
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad))


def slstm_scan(r: torch.Tensor, wx: torch.Tensor, state: SLSTMState):
    """The sLSTM's recurrence over time (:class:`SLSTMScan`), one
    :func:`_slstm_cell` a token from ``state``: ``r`` (H, dh, 4 dh) in the
    compute dtype, ``wx`` (B, S, 4, H, dh) float32 -> ``(hidden states
    (B, S, H, dh) in r's dtype, the last state)``."""
    hid, *last = SLSTMScan.apply(r, wx, *state)
    return hid, SLSTMState(*last)


def slstm_apply(p: SLSTM, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False):
    """Full-sequence sLSTM (pre-normed x (B, S, d)) -> ``(y (B, S, d),
    SLSTMState or None)``; the caller adds the FFN (:func:`slstm_ffn`)."""
    b, s, d = x.shape
    hid, state = slstm_scan(_recurrent(p, x.dtype), _slstm_inputs(p, x),
                            init_slstm_state(cfg, b, x.device))
    y = rmsnorm_head(p.out_norm, hid, cfg.norm_eps).reshape(b, s, d)
    return y, (state if return_state else None)


def slstm_ffn(p: SLSTM, x: torch.Tensor) -> torch.Tensor:
    """The sLSTM block's gated FFN (pre-normed input): GeGLU with the tanh
    GELU."""
    g, u = torch.chunk(x @ cdt(p.ff_up, x.dtype), 2, dim=-1)
    return (gelu_tanh(g) * u) @ cdt(p.ff_down, x.dtype)


def slstm_step(p: SLSTM, x: torch.Tensor, cfg: ArchConfig,
               state: SLSTMState):
    """One-token sLSTM. x (B, 1, d) -> ``(y (B, 1, d), new state)``."""
    b, _, d = x.shape
    new = _slstm_cell(_recurrent(p, x.dtype), state, _slstm_inputs(p, x)[:, 0],
                      x.dtype)
    hid = rmsnorm_head(p.out_norm, new.hid.to(x.dtype)[:, None], cfg.norm_eps)
    return hid.reshape(b, 1, d), new
