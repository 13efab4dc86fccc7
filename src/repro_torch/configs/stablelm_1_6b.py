"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b; unverified].

Assigned: 24L d_model=2048 32H (kv=32, i.e. MHA) d_ff=5632 vocab=100352.
(The HF model uses partial rotary 25%; we apply full rotary — noted deviation,
irrelevant to systems behaviour.)
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=5632,
    vocab_size=100352,
    pattern=(LayerSpec(kind="attn"),),
    long_context_ok=False,
)
