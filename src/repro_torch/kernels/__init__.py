"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``), their
``ctypes`` wrappers and their plain PyTorch versions."""
