"""Whisper-style encoder-decoder (port of ``repro.models.encdec``; the
conv/mel frontend is a stub in both: the encoder takes precomputed frame
embeddings (B, F, d)).

Encoder: bidirectional attention blocks over the frames, through the
flash-attention kernel with ``causal=False`` (its plain version on the
CPU; in training both attentions take its gradient path, the backward
kernel on the card). Decoder: causal self-attention, cross-attention over the encoder's
output, and the MLP, per layer. Where the reference stacks each stack's
parameters and runs ``lax.scan``, the port keeps one block per layer and
a Python loop, as :mod:`repro_torch.models.lm` does.

Decode caches, one :class:`DecCache` per decoder layer: the decoder's
self-attention ``KVCache`` and the cross-attention keys and values
computed from the encoder's output at prefill, fixed after it.

Cross-attention is plain torch (under autograd in training) in the
reference's roundings
(``encdec.py:116-132``): bfloat16 ``q * scale`` and scores, a float32
softmax, bfloat16 probabilities. It has no RoPE. No Pallas kernel
computes it in the reference, and the flash kernel's float32 scores would
not be its bits (the kernel also takes one S for queries and keys).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import DeviceLike, pick_device
from repro_torch.kernels.flash_attention.ref import inv_sqrt, repeat_kv
from repro_torch.models import attention as attn_lib
from repro_torch.models import runtime
from repro_torch.models import spec as spec_lib
from repro_torch.models.attention import KVCache, _out, _proj
from repro_torch.models.layers import (COMPUTE_DTYPE, MLP, Embedding,
                                       RMSNorm, Unembed, embed, mlp, rmsnorm,
                                       unembed)
from repro_torch.models.spec import new_param

_ATTN = LayerSpec(kind="attn")
SEQ_LOGICAL = ("batch", "seq", None)
LOGITS_LOGICAL = ("batch", "seq", "vocab")


class CrossAttention(nn.Module):
    """``wq`` (d, H, dh), ``wk`` and ``wv`` (d, KV, dh), ``wo`` (H, dh, d):
    the reference's ``xattn`` subtree, no QK-norm."""
    LOGICAL = attn_lib.Attention.LOGICAL

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = new_param((d, h, dh), COMPUTE_DTYPE, device)
        self.wk = new_param((d, kv, dh), COMPUTE_DTYPE, device)
        self.wv = new_param((d, kv, dh), COMPUTE_DTYPE, device)
        self.wo = new_param((h, dh, d), COMPUTE_DTYPE, device)


class EncoderBlock(nn.Module):
    """``ln1``, bidirectional ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = attn_lib.Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device)


class DecoderBlock(nn.Module):
    """``ln1``, causal ``self_attn``, ``ln_x``, ``xattn``, ``ln2``,
    ``mlp``."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.self_attn = attn_lib.Attention(cfg, device)
        self.ln_x = RMSNorm(cfg.d_model, device)
        self.xattn = CrossAttention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device)


class DecCache(NamedTuple):
    self_kv: KVCache          # the decoder's self-attention cache
    cross_k: torch.Tensor     # (B, F, KV, dh), fixed after prefill
    cross_v: torch.Tensor


def encode(model: "EncDecModel", frames: torch.Tensor) -> torch.Tensor:
    """The encoder's output (B, F, d) in the model's dtype, from frame
    embeddings ``frames`` (B, F, d) (any float dtype; cast to the
    model's). RoPE positions ``arange(F)``."""
    cfg = model.cfg
    x = frames.to(model.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for block in model.enc_blocks:
        x = runtime.constrain(x, SEQ_LOGICAL)
        h = rmsnorm(block.ln1.scale, x, cfg.norm_eps)
        out, _ = attn_lib.attend_full(block.attn, h, cfg, _ATTN, positions,
                                      causal=False)
        x = x + out
        h2 = rmsnorm(block.ln2.scale, x, cfg.norm_eps)
        x = x + mlp(block.mlp, h2)
    return rmsnorm(model.enc_norm.scale, x, cfg.norm_eps)


def cross_kv(p: CrossAttention, enc: torch.Tensor):
    """The cross-attention keys and values (B, F, KV, dh) of the
    encoder's output."""
    return _proj(enc, p.wk), _proj(enc, p.wv)


def cross_attend(p: CrossAttention, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Attention of x (B, T, d) over every frame's k and v: ``q * scale``
    and the scores in x's dtype (``scale = 1/sqrt(float32(dh))`` rounded
    to it), a float32 softmax, the probabilities rounded back."""
    q = _proj(x, p.wq)
    kk, vv = repeat_kv(k, cfg.n_heads), repeat_kv(v, cfg.n_heads)
    scale = float(torch.tensor(inv_sqrt(cfg.d_head)).to(q.dtype))
    scores = torch.einsum("bthk,bshk->bhts", q * scale, kk).float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhts,bshk->bthk", probs, vv)
    return _out(ctx, p.wo)


def _cross_and_mlp(block: DecoderBlock, x: torch.Tensor, ck: torch.Tensor,
                   cv: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """A decoder layer after its self-attention: cross-attention over the
    keys and values ``ck``, ``cv``, then the MLP, each added to ``x``."""
    hx = rmsnorm(block.ln_x.scale, x, cfg.norm_eps)
    x = x + cross_attend(block.xattn, hx, ck, cv, cfg)
    h2 = rmsnorm(block.ln2.scale, x, cfg.norm_eps)
    return x + mlp(block.mlp, h2)


def _train_layer(block: DecoderBlock, x: torch.Tensor, enc: torch.Tensor,
                 cfg: ArchConfig, positions: torch.Tensor) -> torch.Tensor:
    """Train mode, one decoder layer: causal self-attention, then
    :func:`_cross_and_mlp` over the encoder's output."""
    h = rmsnorm(block.ln1.scale, x, cfg.norm_eps)
    out, _ = attn_lib.attend_full(block.self_attn, h, cfg, _ATTN, positions)
    ck, cv = cross_kv(block.xattn, enc)
    return _cross_and_mlp(block, x + out, ck, cv, cfg)


def forward(model: "EncDecModel", tokens: torch.Tensor, *, mode: str,
            frames: Optional[torch.Tensor] = None,
            caches: Optional[List[DecCache]] = None,
            pos: Optional[int] = None, max_len: int = 0,
            remat: bool = True):
    """Prefill and decode return ``(logits (B, 1, V_pad), new caches)``;
    train returns ``(logits (B, S, V_pad), aux)`` with ``aux`` a float32
    zero (no MoE), as the reference. Prefill and train encode ``frames``
    and run the decoder over ``tokens`` (B, S) at positions ``arange(S)``;
    prefill builds each layer's self-attention cache of ``max_len``
    positions (default S) and its cross keys and values; train recomputes
    each decoder layer in the backward (``torch.utils.checkpoint``, as the
    reference's ``jax.checkpoint`` of its scanned body) unless ``remat``
    is false. Decode takes one token a row at absolute position ``pos``
    and the caches (the self-attention caches are updated in place). The
    last position alone is unembedded in prefill, as
    :func:`repro_torch.models.lm.forward` does."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}; have train, prefill, "
                         f"decode")
    cfg = model.cfg
    x = embed(model.embed.table, tokens, model.dtype)
    decode = mode == "decode"
    if decode:
        if pos is None or caches is None:
            raise ValueError("decode needs the caches and a position")
        positions = enc = None
    else:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its "
                             f"{mode} takes frames= (B, F, d) frame "
                             f"embeddings")
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        enc = encode(model, frames)
        max_len = max_len or x.shape[1]
    if mode == "train":
        for block in model.dec_blocks:
            x = runtime.constrain(x, SEQ_LOGICAL)
            x = (checkpoint(_train_layer, block, x, enc, cfg, positions,
                            use_reentrant=False) if remat
                 else _train_layer(block, x, enc, cfg, positions))
        x = rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
        return (runtime.constrain(unembed(model.unembed.table, x),
                                  LOGITS_LOGICAL),
                torch.zeros((), dtype=torch.float32, device=x.device))
    new_caches = []
    for layer, block in enumerate(model.dec_blocks):
        x = runtime.constrain(x, SEQ_LOGICAL)
        h = rmsnorm(block.ln1.scale, x, cfg.norm_eps)
        if decode:
            cache = caches[layer]
            out, self_kv = attn_lib.attend_decode(block.self_attn, h, cfg,
                                                  _ATTN, cache.self_kv, pos)
            ck, cv = cache.cross_k, cache.cross_v
        else:
            out, (k, v) = attn_lib.attend_full(block.self_attn, h, cfg,
                                               _ATTN, positions)
            self_kv = attn_lib.prefill_cache(_ATTN, k, v, max_len,
                                             dtype=x.dtype)
            ck, cv = cross_kv(block.xattn, enc)
        x = _cross_and_mlp(block, x + out, ck, cv, cfg)
        new_caches.append(DecCache(self_kv, ck, cv))
    if not decode:
        x = x[:, -1:]
    x = rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    return (runtime.constrain(unembed(model.unembed.table, x),
                              LOGITS_LOGICAL), new_caches)


class EncDecModel(nn.Module):
    """The encoder-decoder's weights and serving steps, with the surface
    of :class:`repro_torch.models.Model`: the embedding, one
    :class:`EncoderBlock` per encoder layer and ``enc_norm``, one
    :class:`DecoderBlock` per decoder layer, ``final_norm`` and the
    output head (the reference's tree keys, its stacks unstacked).
    Weights are created uninitialised on ``device`` (the card by
    default); :meth:`init_params` fills them."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None):
        super().__init__()
        dev = pick_device(device)
        self.cfg = cfg
        self.compute_dtype: Optional[torch.dtype] = None
        vocab = cfg.padded_vocab
        self.embed = Embedding(vocab, cfg.d_model, dev)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(cfg, dev) for _ in range(cfg.encoder_layers))
        self.enc_norm = RMSNorm(cfg.d_model, dev)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(cfg, dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, dev)
        self.unembed = Unembed(vocab, cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: ``compute_dtype`` where it is set (a model
        of float32 masters computes in bfloat16), else the weights' own:
        bfloat16 as served, float32 after ``.float()``."""
        return self.compute_dtype or self.embed.table.dtype

    def loss(self, batch, aux_weight: float = 0.01, remat: bool = True):
        """The training loss of ``batch`` (``tokens``, ``labels``,
        ``frames``): see :func:`repro_torch.models.model.lm_loss`."""
        from repro_torch.models.model import lm_loss
        return lm_loss(self, batch, aux_weight, remat)

    def init_params(self, seed: int = 0) -> "EncDecModel":
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on the model's device, by the reference's initialisers."""
        spec_lib.init_params(self, seed)
        return self

    def init_cache(self, batch: int, max_len: int) -> List[DecCache]:
        """Zero decode caches, one :class:`DecCache` per decoder layer:
        ``max_len`` self-attention positions and ``encoder_frames`` cross
        keys and values, bfloat16."""
        cfg = self.cfg
        shape = (batch, cfg.encoder_frames, cfg.n_kv_heads, cfg.d_head)
        return [DecCache(
            attn_lib.init_cache(cfg, _ATTN, batch, max_len, self.device),
            torch.zeros(shape, dtype=COMPUTE_DTYPE, device=self.device),
            torch.zeros(shape, dtype=COMPUTE_DTYPE, device=self.device))
            for _ in range(cfg.n_layers)]

    def prefill(self, tokens: torch.Tensor, max_len: int, *,
                frames: Optional[torch.Tensor] = None):
        """``tokens`` (B, S) and ``frames`` (B, F, d) -> ``(logits (B, 1,
        V_pad) of the last position, caches)``. Without ``frames`` it
        raises ``ValueError``."""
        return forward(self, tokens, mode="prefill", frames=frames,
                       max_len=max_len)

    def decode_step(self, caches: List[DecCache], tokens: torch.Tensor,
                    pos: int):
        """One token a row (``tokens`` (B, 1)) at absolute position
        ``pos``. Returns ``(logits (B, 1, V_pad), caches)``."""
        return forward(self, tokens, mode="decode", caches=caches, pos=pos)
