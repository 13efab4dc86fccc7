"""gemma3-4b [dense] — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt; unverified].

Assigned: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
34 = 5 full groups of 6 + a 4-layer tail (handled unscanned).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

_LOCAL = LayerSpec(kind="attn", window=1024)
_GLOBAL = LayerSpec(kind="attn", window=None)

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10240,
    vocab_size=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    rope_theta=1_000_000.0,
    qk_norm=True,
    long_context_ok=True,
    notes="see gemma3-12b; tail layers = pattern[:4]",
)
