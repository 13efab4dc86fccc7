"""The model facade used by serving (port of ``repro.models.model`` for
the decoder-only language models).

:class:`Model` is an ``nn.Module`` that holds its weights (the reference
passes a parameter tree to each step instead) and exposes the serving
steps: ``prefill`` (the last position's logits and the decode caches) and
``decode_step``. :func:`build_model` makes one on the CUDA card unless
``device="cpu"`` is given, and raises for an architecture the port does
not run yet.
"""
from __future__ import annotations

from typing import Any, List

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, pick_device
from repro_torch.models import lm as lm_lib
from repro_torch.models import spec as spec_lib
from repro_torch.models.layers import Embedding, RMSNorm, Unembed

_ROADMAP = "is still to port: ROADMAP queue 1, item 10"


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP line for a config
    with any layer the port's model does not run."""
    missing = []
    if cfg.is_encdec:
        missing.append("the encoder-decoder (whisper)")
    if cfg.num_patches:
        missing.append("the VLM patch embeddings")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} {_ROADMAP}")


class Model(nn.Module):
    """Embedding, one :class:`~repro_torch.models.lm.Block` per layer, the
    final norm and the output head (absent when the embeddings are tied).
    Weights are created uninitialised on ``device`` (the card by default);
    :meth:`init_params` fills them."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None):
        super().__init__()
        check_ported(cfg)
        dev = pick_device(device)
        self.cfg = cfg
        vocab = cfg.padded_vocab
        self.embed = Embedding(vocab, cfg.d_model, dev)
        self.blocks = nn.ModuleList(
            lm_lib.Block(cfg, ls, dev) for ls in cfg.layers)
        self.final_norm = RMSNorm(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            self.unembed = Unembed(vocab, cfg.d_model, dev)

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

    def prefill(self, tokens: torch.Tensor, max_len: int):
        """``tokens`` (B, S) -> ``(logits (B, 1, V_pad) of the last
        position, caches of max_len positions)``."""
        return lm_lib.forward(self, tokens, mode="prefill", max_len=max_len)

    def decode_step(self, caches: List[Any],
                    tokens: torch.Tensor, pos: int):
        """One token a row (``tokens`` (B, 1)) at absolute position
        ``pos``. Returns ``(logits (B, 1, V_pad), caches)``; attention
        caches are updated in place, recurrent states replaced."""
        return lm_lib.forward(self, tokens, mode="decode", caches=caches,
                              pos=pos)


def build_model(cfg: ArchConfig, *, device: DeviceLike = None,
                seed: int = 0) -> Model:
    """A :class:`Model` of ``cfg`` with random weights from ``seed``, on
    the CUDA card unless ``device`` says otherwise."""
    return Model(cfg, device=device).init_params(seed)
