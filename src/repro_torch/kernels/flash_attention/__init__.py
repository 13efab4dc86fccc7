"""Causal, optionally sliding-window, attention forward: CUDA kernel,
wrapper, plain versions (port of ``repro.kernels.flash_attention``)."""
