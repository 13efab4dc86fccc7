"""The exact budget-capped sequential replay: CUDA kernel, wrapper, plain
version (port of ``repro.kernels.capped_scan``)."""
