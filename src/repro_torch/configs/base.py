"""Architecture configuration (a copy of ``repro.configs.base``'s
:class:`LayerSpec` and :class:`ArchConfig`; the port imports nothing of
``repro``).

Every architecture is an :class:`ArchConfig` built from a repeating
``pattern`` of :class:`LayerSpec` (mixer kind, attention window, MoE flag).
``n_layers // len(pattern)`` groups repeat the pattern; a remainder tail
(e.g. gemma3-4b's 34 = 5*6 + 4) follows them. The fields are the
reference's, field by field, so that ``reduced_config`` gives the same
miniatures; :func:`repro_torch.models.build_model` runs every one of the
registry (an encoder-decoder as
:class:`repro_torch.models.EncDecModel`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"              # attn | mamba | mlstm | slstm
    window: Optional[int] = None    # sliding-window size; None = global attn
    moe: bool = False               # MoE MLP instead of dense MLP


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # --- MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_group_size: int = 1024
    capacity_factor: float = 1.25
    # --- attention details
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    logit_softcap: float = 0.0
    # --- mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # --- xlstm
    xlstm_proj_factor: float = 2.0
    xlstm_slstm_proj: float = 4.0 / 3.0
    # --- encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 0
    # --- vlm
    num_patches: int = 0
    # --- misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    long_context_ok: bool = False
    notes: str = ""

    def __post_init__(self):
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} is not a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the embedding and output
        tables' rows; a pad id is never sampled)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail(self) -> Tuple[LayerSpec, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def layers(self) -> Tuple[LayerSpec, ...]:
        """Every layer's spec in execution order: the groups, then the
        tail."""
        return self.pattern * self.n_groups + self.tail
