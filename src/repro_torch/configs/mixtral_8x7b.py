"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].

Assigned: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8e top-2, sliding-window attention (4096) on every layer.
long_500k RUNS: the SWA window bounds the KV cache.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=32000,
    pattern=(LayerSpec(kind="attn", window=4096, moe=True),),
    n_experts=8,
    top_k=2,
    moe_d_ff=14336,
    rope_theta=1_000_000.0,
    long_context_ok=True,
)
