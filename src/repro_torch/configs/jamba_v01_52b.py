"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].

Assigned: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e
top-2. Period-8 groups: attention at position 4, mamba elsewhere; MoE on every
other layer. long_500k RUNS (hybrid: 28/32 layers are O(1)-state mamba; the 4
attention layers hold sequence-sharded KV).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

def _layer(i: int) -> LayerSpec:
    return LayerSpec(kind="attn" if i == 4 else "mamba", moe=(i % 2 == 1))

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    pattern=tuple(_layer(i) for i in range(8)),
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    long_context_ok=True,
)
