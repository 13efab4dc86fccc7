"""Experiment presets (the paper's §7.1 synthetic configurations, in
:mod:`.paper_auction`) and the language-model registry: ``get_config(name)``
/ ``--arch <id>``.

The registry holds every architecture of ``repro.configs.ARCHS``: the
decoder-only ones, whose layers are attention, mamba, mLSTM or sLSTM mixers
with a dense or MoE MLP; internvl2-76b, a decoder with a prefix of patch
embeddings; and whisper-small, an encoder-decoder fed frame embeddings (both
frontends are stubs, as in the reference). ``get_config`` and
``reduced_config`` are copies of ``repro.configs:29-70``; the reduced
miniatures define the CPU tests and equal the reference's field by field.
``SHAPES`` and ``shape_applicable`` are the dry run's workload shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (SHAPES, ArchConfig, LayerSpec,
                                      ShapeConfig, shape_applicable)
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3_12b
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3_4b
from repro_torch.configs.granite_moe_3b import CONFIG as _granite_moe_3b
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2_20b
from repro_torch.configs.internvl2_76b import CONFIG as _internvl2_76b
from repro_torch.configs.jamba_v01_52b import CONFIG as _jamba_v01_52b
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral_8x7b
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm_1_6b
from repro_torch.configs.whisper_small import CONFIG as _whisper_small
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm_125m

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in [_internvl2_76b, _xlstm_125m, _gemma3_12b,
                        _internlm2_20b, _stablelm_1_6b, _gemma3_4b,
                        _mixtral_8x7b, _granite_moe_3b, _jamba_v01_52b,
                        _whisper_small]
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ArchConfig:
    """A same-family miniature for CPU smoke tests: few layers, narrow dims,
    tiny vocab — exercises every code path of the full config."""
    full = get_config(name)
    pat = full.pattern
    d_head = 32
    n_heads = max(2, min(4, full.n_heads))
    n_kv = full.n_kv_heads and max(1, min(2, full.n_kv_heads))
    if full.n_kv_heads == full.n_heads:     # MHA stays MHA
        n_kv = n_heads
    # shrink windows so local attention actually windows at tiny seq lens
    pat = tuple(dataclasses.replace(
        p, window=(8 if p.window else None)) for p in pat)
    return dataclasses.replace(
        full,
        n_layers=len(pat) * 2 + len(full.tail),
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=d_head,
        d_ff=full.d_ff and 128,
        vocab_size=512,
        pattern=pat,
        n_experts=min(full.n_experts, 8) if full.n_experts else 0,
        top_k=min(full.top_k, 2) if full.top_k else 0,
        moe_d_ff=64 if full.moe_d_ff else 0,
        moe_group_size=16,
        # no-drop capacity so tiny-batch smoke tests are exactly
        # prefill/decode-consistent (capacity drops are load-dependent)
        capacity_factor=8.0,
        encoder_layers=2 if full.encoder_layers else 0,
        encoder_frames=12 if full.encoder_frames else 0,
        num_patches=4 if full.num_patches else 0,
        mamba_d_state=8,
    )


__all__ = ["ARCHS", "SHAPES", "get_config", "reduced_config", "ArchConfig",
           "LayerSpec", "ShapeConfig", "shape_applicable"]
