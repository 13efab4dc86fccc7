"""The model facade used by serving and training (port of
``repro.models.model``).

:class:`Model` is an ``nn.Module`` that holds its weights (the reference
passes a parameter tree to each step instead) and exposes the training
loss (``loss``) and the serving steps: ``prefill`` (the last position's
logits and the decode caches) and ``decode_step``. It is the decoder-only LM, internvl2-76b's patch prefix
included; an encoder-decoder config (whisper-small) gets
:class:`repro_torch.models.encdec.EncDecModel`, with the same surface and
``frames=`` in its prefill. :func:`new_model` picks the class,
:func:`build_model` fills its weights; both make it on the CUDA card
unless ``device="cpu"`` is given. Serving holds the matmul weights in
bfloat16; training asks for ``param_dtype=torch.float32``, the reference's
float32 masters, which every use site casts to the compute dtype
(bfloat16 unless ``compute_dtype`` says otherwise).
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
                                       Unembed, softmax_xent)
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
    LOGICAL = {"w": ("embed", None)}

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
        self.compute_dtype: Optional[torch.dtype] = None
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

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: ``compute_dtype`` where it is set (a model
        of float32 masters computes in bfloat16), else the weights' own:
        bfloat16 as served, float32 after ``.float()``."""
        return self.compute_dtype or self.embed.table.dtype

    def loss(self, batch, aux_weight: float = 0.01, remat: bool = True):
        """The training loss of ``batch`` (``tokens``, ``labels`` and, with
        a patch prefix, ``patch_embeds``): see :func:`lm_loss`."""
        return lm_loss(self, batch, aux_weight, remat)

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


def lm_loss(model: AnyModel, batch, aux_weight: float = 0.01,
            remat: bool = True):
    """``repro``'s ``Model.loss``: the train-mode forward of ``batch`` (a
    dict of ``tokens`` (B, S), ``labels`` (B, S) and the stub frontend's
    ``patch_embeds`` or ``frames``), :func:`softmax_xent` over the labels
    ``>= 0`` (a patch prefix's positions get the label -1) and the MoE
    load-balancing loss. Returns ``(ce + aux_weight * aux, {"ce", "aux",
    "tokens"})``, float32 scalars."""
    cfg = model.cfg
    if cfg.is_encdec:
        logits, aux = encdec_lib.forward(model, batch["tokens"], mode="train",
                                         frames=batch.get("frames"),
                                         remat=remat)
    else:
        logits, aux = lm_lib.forward(model, batch["tokens"], mode="train",
                                     patch_embeds=batch.get("patch_embeds"),
                                     remat=remat)
    labels = batch["labels"]
    if cfg.num_patches:     # logits cover [patches ++ text]
        pad = torch.full((labels.shape[0], cfg.num_patches), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    ce, n_tokens = softmax_xent(logits, labels, cfg.vocab_size)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux, "tokens": n_tokens}


def new_model(cfg: ArchConfig, *, device: DeviceLike = None,
              param_dtype: torch.dtype = COMPUTE_DTYPE) -> AnyModel:
    """An uninitialised model of ``cfg``: an
    :class:`~repro_torch.models.encdec.EncDecModel` for an encoder-decoder,
    else a :class:`Model`. ``param_dtype`` is the dtype its matmul weights
    are held in (norm scales and the recurrent mixers' float32 vectors
    stay float32): bfloat16 for serving, ``torch.float32`` for the
    reference's float32 masters in training, which compute in bfloat16
    (``model.compute_dtype``; set it to ``None`` for a float32 twin that
    computes in its weights' dtype)."""
    check_ported(cfg)
    if cfg.is_encdec:
        model = encdec_lib.EncDecModel(cfg, device=device)
    else:
        model = Model(cfg, device=device)
    if param_dtype != COMPUTE_DTYPE:
        model.to(param_dtype)
        model.compute_dtype = COMPUTE_DTYPE
    return model


def build_model(cfg: ArchConfig, *, device: DeviceLike = None,
                seed: int = 0, param_dtype: torch.dtype = COMPUTE_DTYPE
                ) -> AnyModel:
    """A model of ``cfg`` (:func:`new_model`) with random weights from
    ``seed``, on the CUDA card unless ``device`` says otherwise."""
    return new_model(cfg, device=device,
                     param_dtype=param_dtype).init_params(seed)
