"""Decoder-only LM assembly (port of ``repro.models.lm``).

Layers are the config's ``n_groups`` repetitions of its ``pattern``,
then the unscanned tail (gemma3-4b's 34 = 5*6 + 4). Where the reference
stacks each group's parameters and runs ``lax.scan``, the port keeps one
:class:`Block` per layer and a Python loop. A block is one of the
reference's five kinds: attention or mamba, each followed by a dense or
MoE MLP; mLSTM (self-contained); sLSTM followed by its own gated FFN.
Three modes share one code path:

* ``train``   — the full sequence, logits at every position, the MoE
  load-balancing losses summed over the blocks, no caches; each block is
  recomputed in the backward (``torch.utils.checkpoint``, the counterpart
  of the reference's per-group ``jax.checkpoint(nothing_saveable)``)
  except an sLSTM block, whose scan keeps its (B, S)-sized states itself
  (~0.4 GB a layer at xlstm-125m's 8 x 2,048 tokens) and whose token loop
  is host-bound, so a recompute would only run it again. Every kind
  trains: attention through the flash kernels' autograd Function, mamba
  through :class:`~repro_torch.models.mamba.SelectiveScan`, the sLSTM
  through :class:`~repro_torch.models.xlstm.SLSTMScan`, the mLSTM under
  plain autograd;
* ``prefill`` — the full sequence; emits one decode cache per layer (a
  ``KVCache``, ``MambaState``, ``MLSTMState`` or ``SLSTMState``);
* ``decode``  — one token; consumes the caches and returns them updated.

VLM (internvl2): precomputed patch embeddings (B, P, d) (the vision
frontend is a stub, as in the reference) are projected by ``patch_proj``
and placed ahead of the token embeddings; positions and the caches run
over the P + S positions.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import runtime
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (MLP, RMSNorm, cdt, embed, mlp,
                                       rmsnorm, unembed)

ACT_LOGICAL = ("batch", "act_seq", None)
LOGITS_LOGICAL = ("batch", "seq", "vocab")


class Block(nn.Module):
    """One layer of ``spec.kind``: ``ln1`` and the mixer (``attn``,
    ``mamba``, ``mlstm`` or ``slstm``); for attention and mamba ``ln2``
    and the ``mlp`` or ``moe``; for sLSTM ``ln_ff`` before its FFN. The
    attribute names are the reference's tree keys."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec,
                 device: torch.device):
        super().__init__()
        self.spec = spec
        self.ln1 = RMSNorm(cfg.d_model, device)
        if spec.kind == "attn":
            self.attn = attn_lib.Attention(cfg, device)
        elif spec.kind == "mamba":
            self.mamba = mamba_lib.Mamba(cfg, device)
        elif spec.kind == "mlstm":
            self.mlstm = xlstm_lib.MLSTM(cfg, device)
            return
        elif spec.kind == "slstm":
            self.slstm = xlstm_lib.SLSTM(cfg, device)
            self.ln_ff = RMSNorm(cfg.d_model, device)
            return
        else:
            raise ValueError(f"unknown layer kind {spec.kind!r}")
        self.ln2 = RMSNorm(cfg.d_model, device)
        if spec.moe:
            self.moe = moe_lib.MoE(cfg, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, device)


def lm_param_shapes(cfg: ArchConfig) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(name, shape)`` of every parameter of the decoder-only LM of
    ``cfg``, in :class:`~repro_torch.models.Model`'s order and names, built
    on the ``meta`` device: the layout ``repro``'s ``lm.param_specs``
    describes, which its parameter estimate counts for every config (an
    encoder-decoder's included)."""
    meta = torch.device("meta")
    d, vocab = cfg.d_model, cfg.padded_vocab
    out = [("embed.table", (vocab, d))]
    for i, spec in enumerate(cfg.layers):
        out += [(f"blocks.{i}.{name}", tuple(p.shape)) for name, p
                in Block(cfg, spec, meta).named_parameters()]
    out.append(("final_norm.scale", (d,)))
    if not cfg.tie_embeddings:
        out.append(("unembed.table", (vocab, d)))
    if cfg.num_patches:
        out.append(("patch_proj.w", (d, d)))
    return out


def init_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int,
               device: torch.device):
    """A zero decode cache of one layer, in the reference's dtypes."""
    if spec.kind == "attn":
        return attn_lib.init_cache(cfg, spec, batch, max_len, device)
    if spec.kind == "mamba":
        return mamba_lib.init_state(cfg, batch, device)
    if spec.kind == "mlstm":
        return xlstm_lib.init_mlstm_state(cfg, batch, device)
    return xlstm_lib.init_slstm_state(cfg, batch, device)


def apply_block(p: Block, x: torch.Tensor, cfg: ArchConfig, mode: str,
                cache: Any, pos: Optional[int],
                positions: Optional[torch.Tensor], max_len: int):
    """Prefill or decode: returns ``(x, new_cache)`` (the MoE's
    load-balancing loss is for training, :func:`train_block`)."""
    h = rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    decode = mode == "decode"
    kind = p.spec.kind
    if kind == "attn":
        if decode:
            out, new_cache = attn_lib.attend_decode(p.attn, h, cfg, p.spec,
                                                    cache, pos)
        else:
            out, (k, v) = attn_lib.attend_full(p.attn, h, cfg, p.spec,
                                               positions)
            new_cache = attn_lib.prefill_cache(p.spec, k, v, max_len,
                                               dtype=x.dtype)
    elif kind == "mamba":
        out, new_cache = (mamba_lib.mamba_step(p.mamba, h, cfg, cache)
                          if decode else mamba_lib.mamba_apply(
                              p.mamba, h, cfg, return_state=True))
    elif kind == "mlstm":
        out, new_cache = (xlstm_lib.mlstm_step(p.mlstm, h, cfg, cache)
                          if decode else xlstm_lib.mlstm_apply(
                              p.mlstm, h, cfg, return_state=True))
        return x + out, new_cache
    else:
        out, new_cache = (xlstm_lib.slstm_step(p.slstm, h, cfg, cache)
                          if decode else xlstm_lib.slstm_apply(
                              p.slstm, h, cfg, return_state=True))
        x = x + out
        hf = rmsnorm(p.ln_ff.scale, x, cfg.norm_eps)
        return x + xlstm_lib.slstm_ffn(p.slstm, hf), new_cache
    x = x + out
    return _mlp_sublayer(p, x, cfg)[0], new_cache


def _mlp_sublayer(p: Block, x: torch.Tensor, cfg: ArchConfig):
    """``x`` plus the dense or MoE MLP of ``ln2(x)``, and the MoE's
    load-balancing loss (None for a dense MLP)."""
    h2 = rmsnorm(p.ln2.scale, x, cfg.norm_eps)
    if p.spec.moe:
        out2, aux = moe_lib.moe_apply(p.moe, h2, cfg)
        return x + out2, aux
    return x + mlp(p.mlp, h2), None


def train_block(p: Block, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor):
    """Train mode, a block of any kind, composed as :func:`apply_block`
    composes it: returns ``(x, aux)``, ``aux`` the MoE's load-balancing
    loss (float32; 0 without a MoE)."""
    h = rmsnorm(p.ln1.scale, x, cfg.norm_eps)
    kind, aux = p.spec.kind, None
    if kind == "attn":
        out, _ = attn_lib.attend_full(p.attn, h, cfg, p.spec, positions)
    elif kind == "mamba":
        out, _ = mamba_lib.mamba_apply(p.mamba, h, cfg)
    elif kind == "mlstm":
        out, _ = xlstm_lib.mlstm_apply(p.mlstm, h, cfg)
    else:
        out, _ = xlstm_lib.slstm_apply(p.slstm, h, cfg)
    x = x + out
    if kind in ("attn", "mamba"):
        x, aux = _mlp_sublayer(p, x, cfg)
    elif kind == "slstm":
        hf = rmsnorm(p.ln_ff.scale, x, cfg.norm_eps)
        x = x + xlstm_lib.slstm_ffn(p.slstm, hf)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def forward(model, tokens: torch.Tensor, *, mode: str = "prefill",
            caches: Optional[List[Any]] = None,
            pos: Optional[int] = None, max_len: int = 0,
            patch_embeds: Optional[torch.Tensor] = None,
            remat: bool = True):
    """Prefill and decode return ``(logits (B, 1, V_pad), new caches)``;
    train returns ``(logits (B, P + S, V_pad), aux)``, ``aux`` the MoE
    load-balancing losses summed over the blocks (float32).
    ``model`` is a :class:`repro_torch.models.Model`; ``tokens`` (B, S)
    int; the activations are in ``model.dtype``. Prefill unembeds the last
    position alone (the reference unembeds every position and the serving
    path keeps the last; the rows are the same) and builds a cache per
    layer of ``max_len`` positions (default S). Decode takes one token a
    row at absolute position ``pos`` and a cache per layer. Train runs
    every block but an sLSTM one under ``torch.utils.checkpoint`` unless
    ``remat`` is false. A train or
    prefill step of a config with ``num_patches`` takes ``patch_embeds``
    (B, P, d) (any float dtype; cast to the model's): ``patch_embeds @
    patch_proj.w`` leads the token embeddings, and ``max_len`` counts the
    patches. Without them, or with them for a config that has none, it
    raises ``ValueError``."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}; have train, prefill, "
                         f"decode")
    cfg = model.cfg
    train = mode == "train"
    dtype = model.dtype
    x = embed(model.embed.table, tokens, dtype)
    if mode != "decode" and cfg.num_patches:
        if patch_embeds is None:
            raise ValueError(f"{cfg.name} has a patch prefix: its {mode} "
                             f"takes patch_embeds= (B, {cfg.num_patches}, "
                             f"d) patch embeddings")
        w = cdt(model.patch_proj.w, dtype)
        x = torch.cat([patch_embeds.to(dtype) @ w, x], dim=1)
    elif patch_embeds is not None:
        raise ValueError(f"{cfg.name} takes no patch embeddings in "
                         f"{mode}")
    b, s, _ = x.shape
    if mode == "decode":
        if pos is None or caches is None:
            raise ValueError("decode needs the caches and a position")
        positions = None
    else:
        positions = torch.arange(s, device=x.device)[None, :]
        max_len = max_len or s
    new_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # the reference's scanned groups name the residual's layout at their
    # entry and exit (not in decode, whose groups run unscanned)
    width = len(cfg.pattern)
    grouped = cfg.n_groups * width if mode != "decode" else 0
    for layer, block in enumerate(model.blocks):
        if layer < grouped and layer % width == 0:
            x = runtime.constrain(x, ACT_LOGICAL)
        if train:
            x, a = (checkpoint(train_block, block, x, cfg, positions,
                               use_reentrant=False)
                    if remat and block.spec.kind != "slstm"
                    else train_block(block, x, cfg, positions))
            aux = aux + a
        else:
            cache = None if caches is None else caches[layer]
            x, nc = apply_block(block, x, cfg, mode, cache, pos, positions,
                                max_len)
            new_caches.append(nc)
        if layer < grouped and layer % width == width - 1:
            x = runtime.constrain(x, ACT_LOGICAL)
    if mode == "prefill":
        x = x[:, -1:]
    x = rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    if cfg.tie_embeddings:      # the reference's tied product names no layout
        logits = x @ cdt(model.embed.table, x.dtype).T
    else:
        logits = unembed(model.unembed.table, x)
    logits = runtime.constrain(logits, LOGITS_LOGICAL)
    return logits, (aux if train else new_caches)
