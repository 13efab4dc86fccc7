"""The language models: the decoder-only ones (attention, MoE, mamba and
xLSTM layers, and the VLM's patch prefix) and the encoder-decoder (port of
``repro.models``)."""
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.model import Model, build_model, new_model

__all__ = ["EncDecModel", "Model", "build_model", "new_model"]
