"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

Assigned: 12L d_model=768 4H d_ff=0 vocab=50304. d_ff=0 because xLSTM blocks
carry their own projections (mLSTM: pre-up-projection factor 2; sLSTM:
post-up-projection gated FFN factor 4/3). Ratio mLSTM:sLSTM = 5:1 per group
(xLSTM[7:1]-flavoured placement at this depth).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_head=192,
    d_ff=0,
    vocab_size=50304,
    pattern=(
        LayerSpec(kind="mlstm"), LayerSpec(kind="mlstm"),
        LayerSpec(kind="mlstm"), LayerSpec(kind="mlstm"),
        LayerSpec(kind="mlstm"), LayerSpec(kind="slstm"),
    ),
    xlstm_proj_factor=2.0,
    xlstm_slstm_proj=4.0 / 3.0,
    long_context_ok=True,   # recurrent: O(1) state per token
    notes="matrix-memory mLSTM (parallel form for train/prefill, recurrent "
          "for decode) + scalar-memory sLSTM (scan)",
)
