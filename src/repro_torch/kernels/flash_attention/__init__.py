"""Causal, optionally sliding-window, attention: the forward and its
backward as CUDA kernels, their wrappers and plain versions (port of
``repro.kernels.flash_attention``; the backward replaces XLA's autodiff of
the reference's attention)."""
