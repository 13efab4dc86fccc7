"""internvl2-76b [vlm] — InternViT-6B + InternLM2-72B backbone.

Assigned: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[arXiv:2404.16821; unverified]. The vision frontend is a STUB per the task
spec: ``input_specs()`` provides precomputed patch embeddings (256 patches)
that are concatenated ahead of the text tokens.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=128256,
    pattern=(LayerSpec(kind="attn"),),
    rope_theta=1_000_000.0,
    num_patches=256,
    long_context_ok=False,
    notes="dense LLaMA-style backbone; ViT frontend stubbed as patch embeds",
)
