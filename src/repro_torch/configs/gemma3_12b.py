"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

Assigned: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]. Local window 1024; every 6th layer
global. QK-norm per gemma3. long_500k is RUN: 40/48 layers are window-bounded;
the 8 global layers hold the full KV, sequence-sharded over the model axis
(decode is O(L) per token; memory is the binding constraint and is sharded).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

_LOCAL = LayerSpec(kind="attn", window=1024)
_GLOBAL = LayerSpec(kind="attn", window=None)

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab_size=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    rope_theta=1_000_000.0,
    qk_norm=True,
    long_context_ok=True,
    notes="5:1 local:global; local rope theta differences folded into one theta",
)
