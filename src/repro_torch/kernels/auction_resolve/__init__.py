"""The fused Algorithm-2 round: CUDA kernels, wrappers, plain versions."""
