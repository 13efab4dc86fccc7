"""granite-moe-3b-a800m [moe] — [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

Assigned: 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155,
MoE 40e top-8. The tiny per-expert d_ff with many experts makes this the
expert-parallel stress case: the "expert" logical axis maps to the model mesh
axis here (EP), unlike mixtral (TP over ff).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,
    pattern=(LayerSpec(kind="attn", moe=True),),
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    moe_group_size=512,     # 40 experts x top-8: smaller dispatch groups
    long_context_ok=False,
    notes="vocab padded 49155->49408 for shardability (pad ids masked in loss)",
)
