"""GQA attention (port of ``repro.models.attention``): train and prefill
through the flash-attention kernel, cached decode.

* Train and prefill attention (:func:`causal_attention`) is the
  documented fast path of the reference made real: on a CUDA tensor it is
  the hand-written kernel ``csrc/flash_attention.cu`` (float32 scores and
  softmax; on bfloat16 tensors the probabilities reach its tensor cores as
  two bfloat16 terms, 16 significant bits), on a CPU tensor the kernel's
  plain version. Nothing falls back from one to the other. Where autograd
  records (training), the forward also keeps each row's logsumexp and the
  gradient is the backward kernel ``csrc/flash_attention_bwd.cu`` (the
  plain backward on the CPU), which recomputes the score tiles as the
  reference's remat does.
* Decode (:func:`attend_decode`) is plain torch matmuls, as the reference
  leaves it to XLA, in the reference's dtypes: bfloat16 scores rounded,
  a float32 softmax, bfloat16 probabilities.
* Sliding-window layers keep *rolling* decode caches of length ``window``
  (slot = position % window).

The reference's arrays are immutable; the port writes a decode step's key
and value into the cache in place, which saves a copy of the whole cache a
step, and returns the same cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG, inv_sqrt, repeat_kv
from repro_torch.models import runtime
from repro_torch.models.layers import COMPUTE_DTYPE, cdt, rmsnorm_head, rope
from repro_torch.models.spec import new_param


class Attention(nn.Module):
    """``wq`` (d, H, dh), ``wk`` and ``wv`` (d, KV, dh), ``wo`` (H, dh, d),
    the reference's layouts; QK-norm scales (dh,) when the config has
    them."""
    INIT = {"q_norm": "ones", "k_norm": "ones"}
    LOGICAL = {"wq": ("embed", "heads", "head_dim"),
               "wk": ("embed", "kv_heads", "head_dim"),
               "wv": ("embed", "kv_heads", "head_dim"),
               "wo": ("heads", "head_dim", "embed"),
               "q_norm": (None,), "k_norm": (None,)}

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = new_param((d, h, dh), COMPUTE_DTYPE, device)
        self.wk = new_param((d, kv, dh), COMPUTE_DTYPE, device)
        self.wv = new_param((d, kv, dh), COMPUTE_DTYPE, device)
        self.wo = new_param((h, dh, d), COMPUTE_DTYPE, device)
        if cfg.qk_norm:
            self.q_norm = new_param((dh,), torch.float32, device)
            self.k_norm = new_param((dh,), torch.float32, device)


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_cache, KV, dh)
    v: torch.Tensor       # (B, S_cache, KV, dh)


def cache_len(layer: LayerSpec, max_len: int) -> int:
    return min(max_len, layer.window) if layer.window else max_len


def init_cache(cfg: ArchConfig, layer: LayerSpec, batch: int, max_len: int,
               device: torch.device) -> KVCache:
    shape = (batch, cache_len(layer, max_len), cfg.n_kv_heads, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
                   v=torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device))


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, cdt(w))``."""
    d, heads, dh = w.shape
    return (x @ cdt(w, x.dtype).reshape(d, heads * dh)).unflatten(
        -1, (heads, dh))


KV_LOGICAL = ("batch", "kv_seq", "kv_heads", "head_dim")


def _weight(p: Attention, name: str, dtype: torch.dtype) -> torch.Tensor:
    """The weight ``name`` cast to ``dtype``, its compute-time layout
    named (``runtime.gather_weight``)."""
    return runtime.gather_weight(cdt(getattr(p, name), dtype),
                                 Attention.LOGICAL[name])


def _qkv(p: Attention, x: torch.Tensor, cfg: ArchConfig,
         positions: torch.Tensor):
    q, k, v = (_proj(x, _weight(p, w, x.dtype)) for w in ("wq", "wk", "wv"))
    q = runtime.constrain(q, ("batch", "seq", "heads", "head_dim"))
    k = runtime.constrain(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = runtime.constrain(v, ("batch", "seq", "kv_heads", "head_dim"))
    if cfg.qk_norm:
        q = rmsnorm_head(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm_head(p.k_norm, k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", ctx, cdt(wo))``."""
    h, dh, d = wo.shape
    return ctx.flatten(-2) @ cdt(wo, ctx.dtype).reshape(h * dh, d)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: Optional[int] = None,
                     causal: bool = True) -> torch.Tensor:
    """Exact attention, q (B, S, H, dh), k and v (B, S, KV, dh), through
    the flash-attention kernel (its plain version on the CPU): float32
    scores and softmax, the output in q's dtype; differentiable through
    the backward kernel where autograd records."""
    return flash_attention(q, k, v, causal=causal, window=window)


def attend_full(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                layer: LayerSpec, positions: torch.Tensor,
                causal: bool = True):
    """Train and prefill path. Returns ``(out, (k, v))``, k and v for the
    cache."""
    q, k, v = _qkv(p, x, cfg, positions)
    ctx = causal_attention(q, k, v, window=layer.window, causal=causal)
    return _out(ctx, _weight(p, "wo", ctx.dtype)), (k, v)


def attend_decode(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                  layer: LayerSpec, cache: KVCache, pos: int):
    """One-token decode. x (B, 1, d); ``pos`` the position of this token.

    Window layers use a rolling cache (slot = pos % window); RoPE is
    applied before the cache, so stored keys carry absolute phases. The
    cache is updated in place and returned."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)

    s_cache = cache.k.shape[1]
    slot = pos % s_cache
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    runtime.constrain(cache.k, KV_LOGICAL)
    runtime.constrain(cache.v, KV_LOGICAL)

    # absolute position held by each slot j: largest n <= pos with n % S == j
    j = torch.arange(s_cache, device=x.device)
    slot_pos = pos - ((pos - j) % s_cache)
    valid = slot_pos >= 0
    if layer.window is not None:
        valid &= slot_pos > pos - layer.window

    kk, vv = repeat_kv(cache.k, cfg.n_heads), repeat_kv(cache.v, cfg.n_heads)
    scale = float(torch.tensor(inv_sqrt(cfg.d_head)).to(q.dtype))
    scores = torch.einsum("bthk,bshk->bhts", q * scale, kk).float()
    scores = torch.where(valid[None, None, None, :], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhts,bshk->bthk", probs, vv)
    return _out(ctx, p.wo), cache


def prefill_cache(layer: LayerSpec, k: torch.Tensor, v: torch.Tensor,
                  max_len: int, dtype: torch.dtype = COMPUTE_DTYPE
                  ) -> KVCache:
    """A decode cache from prefill's k and v (B, S, KV, dh), in ``dtype``
    (the reference's bfloat16; a float32 copy of a model passes its own).

    Window layers keep the last ``window`` positions, stored
    rolling-aligned (slot = position % window) so decode continues
    seamlessly."""
    s = k.shape[1]
    s_cache = cache_len(layer, max_len)
    if s >= s_cache:
        # roll so that absolute position p sits in slot p % s_cache
        shift = (s - s_cache) % s_cache
        k_c = torch.roll(k[:, s - s_cache:], shift, dims=1).to(dtype)
        v_c = torch.roll(v[:, s - s_cache:], shift, dims=1).to(dtype)
    else:
        shape = (k.shape[0], s_cache) + tuple(k.shape[2:])
        k_c = torch.zeros(shape, dtype=dtype, device=k.device)
        v_c = torch.zeros(shape, dtype=dtype, device=k.device)
        k_c[:, :s] = k
        v_c[:, :s] = v
    return KVCache(k=runtime.constrain(k_c, KV_LOGICAL),
                   v=runtime.constrain(v_c, KV_LOGICAL))
