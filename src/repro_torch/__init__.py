"""repro_torch: the PyTorch / CUDA port of ``repro``'s counterfactual
simulation for large-scale systems with burnout variables.

The module layout mirrors ``repro`` (``core``, ``data``, ``configs``,
``kernels``), so each function's counterpart sits at the same path. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``; with
no card visible they raise instead of falling back (:func:`pick_device`).
Kernels are hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` on
first use (:mod:`repro_torch.kernels.build`).
"""
from repro_torch.device import pick_device

__version__ = "0.1.0"

__all__ = ["pick_device"]
