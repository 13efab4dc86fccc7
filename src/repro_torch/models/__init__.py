"""The decoder-only language models: attention, MoE, mamba and xLSTM
layers (port of ``repro.models``)."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
