"""Where the port's tensors live.

Every entry point takes a ``device`` argument. ``None`` means the CUDA card;
when no card is visible that is an error, never a quiet switch to the CPU —
a caller who wants the CPU (the tests, a laptop) says ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def pick_device(device: DeviceLike = None) -> torch.device:
    """Normalise ``device``; ``None`` is ``"cuda"``. Raises ``RuntimeError``
    when CUDA is asked for (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "the plain PyTorch path on the CPU.")
    return dev
