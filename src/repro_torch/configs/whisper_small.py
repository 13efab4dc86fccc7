"""whisper-small [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

Assigned: 12L d_model=768 12H d_ff=3072 vocab=51865. Interpreted as the true
whisper-small layout: 12 encoder + 12 decoder layers. The conv/mel frontend is
a STUB per the task spec: ``input_specs()`` provides precomputed frame
embeddings (1500 frames) fed straight to the encoder stack.

decode shapes run (enc-dec has a decoder); long_500k is skipped (decoder is
positionally capped far below 512k and the arch is full-attention).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,              # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=51865,
    pattern=(LayerSpec(kind="attn"),),
    encoder_layers=12,
    encoder_frames=1500,
    long_context_ok=False,
    notes="vocab padded 51865->52224; sinusoidal pos folded into rope for "
          "simplicity (systems-irrelevant deviation, noted)",
)
