"""Decoder-only LM assembly (port of ``repro.models.lm`` for dense
attention layers).

Layers are the config's ``n_groups`` repetitions of its ``pattern``,
then the unscanned tail (gemma3-4b's 34 = 5*6 + 4). Where the reference
stacks each group's parameters and runs ``lax.scan``, the port keeps one
:class:`Block` per layer and a Python loop. Two modes share one code path:

* ``prefill`` — the full sequence; emits one decode cache per layer;
* ``decode``  — one token; consumes the caches and returns them updated.

``train`` mode raises: training is still to port (ROADMAP queue 1, item
10).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (MLP, RMSNorm, embed, mlp, rmsnorm,
                                       unembed)

TRAINING_TODO = ("training (softmax_xent, train/, launch/train.py, "
                 "data/tokens.py) is still to port: ROADMAP queue 1, item 10")


class Block(nn.Module):
    """One ``kind="attn"`` layer with a dense MLP: pre-norm attention and
    pre-norm SwiGLU, each added to the residual."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec,
                 device: torch.device):
        super().__init__()
        self.spec = spec
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = attn_lib.Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device)


def apply_block(p: Block, x: torch.Tensor, cfg: ArchConfig, mode: str,
                cache: Optional[attn_lib.KVCache], pos: Optional[int],
                positions: Optional[torch.Tensor], max_len: int):
    """Returns ``(x, new_cache)``."""
    h = rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    if mode == "decode":
        out, new_cache = attn_lib.attend_decode(p.attn, h, cfg, p.spec, cache,
                                                pos)
    else:
        out, (k, v) = attn_lib.attend_full(p.attn, h, cfg, p.spec, positions)
        new_cache = attn_lib.prefill_cache(p.spec, k, v, max_len)
    x = x + out
    h2 = rmsnorm(p.ln2.scale, x, cfg.norm_eps)
    return x + mlp(p.mlp, h2), new_cache


def forward(model, tokens: torch.Tensor, *, mode: str = "prefill",
            caches: Optional[List[attn_lib.KVCache]] = None,
            pos: Optional[int] = None, max_len: int = 0):
    """Returns ``(logits (B, 1, V_pad), new caches)``. ``model`` is a
    :class:`repro_torch.models.Model`; ``tokens`` (B, S) int. Prefill
    unembeds the last position alone (the reference unembeds every
    position and the serving path keeps the last; the rows are the same)
    and builds a cache per layer of ``max_len`` positions (default S).
    Decode takes one token a row at absolute position ``pos`` and a cache
    per layer."""
    if mode == "train":
        raise NotImplementedError(TRAINING_TODO)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}; have prefill, decode")
    cfg = model.cfg
    x = embed(model.embed.table, tokens)
    b, s, _ = x.shape
    if mode == "decode":
        if pos is None or caches is None:
            raise ValueError("decode needs the caches and a position")
        positions = None
    else:
        positions = torch.arange(s, device=x.device)[None, :]
        max_len = max_len or s
    new_caches = []
    for layer, block in enumerate(model.blocks):
        cache = None if caches is None else caches[layer]
        x, nc = apply_block(block, x, cfg, mode, cache, pos, positions,
                            max_len)
        new_caches.append(nc)
    if mode == "prefill":
        x = x[:, -1:]
    x = rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    table = (model.embed.table if cfg.tie_embeddings
             else model.unembed.table)
    return unembed(table, x), new_caches
