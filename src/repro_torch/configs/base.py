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

:class:`ShapeConfig`, :data:`SHAPES` and :func:`shape_applicable` are the
dry run's workload shapes (``repro.configs.base:124-147``, field by field
and with the reference's reason texts).
"""
from __future__ import annotations

import dataclasses
import math
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

    def param_count_estimate(self) -> int:
        """The reference's figure for the 6·N·D accounting: the parameters
        of the decoder-only LM of this config (embedding, every layer, the
        final norm, the output head, the patch projection). Like
        ``repro``'s, it counts that layout for every config, whisper-small
        included, whose encoder-decoder holds more (334,674,432 against
        193,088,256: :func:`repro_torch.models.spec.count_params` of its
        model counts those)."""
        return sum(math.prod(shape) for _, shape in _lm_param_shapes(self))

    def active_param_count_estimate(self) -> int:
        """Parameters touched per token (MoE: ``top_k`` of ``n_experts``):
        the estimate less the share of the expert weights that a token
        skips. The expert weights are the reference's: the ``moe`` leaves
        of three or more dims with ``n_experts`` in their shape, tested on
        its stacked leaves, where a grouped layer's leaf has a leading
        ``n_groups`` axis (so its router, ``(n_groups, d, e)``, counts too;
        a tail layer's does not)."""
        shapes = _lm_param_shapes(self)
        total = sum(math.prod(shape) for _, shape in shapes)
        if self.n_experts == 0:
            return total
        grouped = self.n_groups * len(self.pattern)
        expert = 0
        for name, shape in shapes:
            if ".moe." not in name:
                continue
            stacked = ((self.n_groups,) + shape
                       if int(name.split(".")[1]) < grouped else shape)
            if len(stacked) >= 3 and self.n_experts in stacked:
                expert += math.prod(shape)
        return total - expert + int(expert * self.top_k / self.n_experts)


def _lm_param_shapes(cfg: ArchConfig):
    # imported here: the models import this module
    from repro_torch.models.lm import lm_param_shapes
    return lm_param_shapes(cfg)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode
    microbatches: int = 1


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell is runnable, and why not if not."""
    if shape.name == "long_500k" and not arch.long_context_ok:
        return False, ("skipped: pure full-attention architecture (task rule: "
                       "long_500k needs sub-quadratic attention)")
    if shape.name == "long_500k" and arch.is_encdec:
        return False, "skipped: whisper decoder is positionally capped << 512k"
    return True, ""
