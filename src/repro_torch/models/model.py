"""The model facade used by serving (port of ``repro.models.model``).

:class:`Model` is an ``nn.Module`` that holds its weights (the reference
passes a parameter tree to each step instead) and exposes the serving
steps: ``prefill`` (the last position's logits and the decode caches) and
``decode_step``. It is the decoder-only LM, internvl2-76b's patch prefix
included; an encoder-decoder config (whisper-small) gets
:class:`repro_torch.models.encdec.EncDecModel`, with the same surface and
``frames=`` in its prefill. :func:`new_model` picks the class,
:func:`build_model` fills its weights; both make it on the CUDA card
unless ``device="cpu"`` is given.
"""
from __future__ import annotations

from typing import Any, List, Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import DeviceLike, pick_device
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models import spec as spec_lib
from repro_torch.models.layers import (COMPUTE_DTYPE, Embedding, RMSNorm,
                                       Unembed)
from repro_torch.models.spec import new_param


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port's models do not
    run. Every architecture of the registry runs; an encoder-decoder is
    whisper's stack, attention layers with a dense MLP and no patch
    prefix (``repro.models.encdec`` reads neither the pattern nor
    patches, so another pattern would silently be served as attention)."""
    if cfg.is_encdec and (cfg.num_patches or cfg.tie_embeddings or any(
            ls != LayerSpec(kind="attn") for ls in cfg.layers)):
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder runs plain attention layers "
            f"with a dense MLP, untied embeddings and no patch prefix")


class PatchProj(nn.Module):
    """The VLM's patch projection ``w`` (d, d)."""

    def __init__(self, d_model: int, device: torch.device):
        super().__init__()
        self.w = new_param((d_model, d_model), COMPUTE_DTYPE, device)


class Model(nn.Module):
    """Embedding, one :class:`~repro_torch.models.lm.Block` per layer, the
    final norm, the output head (absent when the embeddings are tied) and,
    with ``num_patches``, the patch projection ``patch_proj``. Weights are
    created uninitialised on ``device`` (the card by default);
    :meth:`init_params` fills them."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None):
        super().__init__()
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             f"with new_model or build_model")
        dev = pick_device(device)
        self.cfg = cfg
        vocab = cfg.padded_vocab
        self.embed = Embedding(vocab, cfg.d_model, dev)
        self.blocks = nn.ModuleList(
            lm_lib.Block(cfg, ls, dev) for ls in cfg.layers)
        self.final_norm = RMSNorm(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            self.unembed = Unembed(vocab, cfg.d_model, dev)
        if cfg.num_patches:
            self.patch_proj = PatchProj(cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def init_params(self, seed: int = 0) -> "Model":
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on the model's device, by the reference's initialisers."""
        spec_lib.init_params(self, seed)
        return self

    def init_cache(self, batch: int, max_len: int) -> List[Any]:
        """Zero decode caches, one per layer: a ``KVCache`` of an attention
        layer (windowed layers hold ``window`` positions), a
        ``MambaState``, ``MLSTMState`` or ``SLSTMState`` of a recurrent
        one."""
        return [lm_lib.init_cache(self.cfg, ls, batch, max_len, self.device)
                for ls in self.cfg.layers]

    def prefill(self, tokens: torch.Tensor, max_len: int, *,
                patch_embeds: Optional[torch.Tensor] = None):
        """``tokens`` (B, S) -> ``(logits (B, 1, V_pad) of the last
        position, caches of max_len positions)``. A config with
        ``num_patches`` takes ``patch_embeds`` (B, P, d), placed ahead of
        the tokens (``max_len`` counts them); without them it raises
        ``ValueError``."""
        return lm_lib.forward(self, tokens, mode="prefill", max_len=max_len,
                              patch_embeds=patch_embeds)

    def decode_step(self, caches: List[Any],
                    tokens: torch.Tensor, pos: int):
        """One token a row (``tokens`` (B, 1)) at absolute position
        ``pos``. Returns ``(logits (B, 1, V_pad), caches)``; attention
        caches are updated in place, recurrent states replaced."""
        return lm_lib.forward(self, tokens, mode="decode", caches=caches,
                              pos=pos)


AnyModel = Union[Model, encdec_lib.EncDecModel]


def new_model(cfg: ArchConfig, *, device: DeviceLike = None) -> AnyModel:
    """An uninitialised model of ``cfg``: an
    :class:`~repro_torch.models.encdec.EncDecModel` for an encoder-decoder,
    else a :class:`Model`."""
    check_ported(cfg)
    if cfg.is_encdec:
        return encdec_lib.EncDecModel(cfg, device=device)
    return Model(cfg, device=device)


def build_model(cfg: ArchConfig, *, device: DeviceLike = None,
                seed: int = 0) -> AnyModel:
    """A model of ``cfg`` (:func:`new_model`) with random weights from
    ``seed``, on the CUDA card unless ``device`` says otherwise."""
    return new_model(cfg, device=device).init_params(seed)
