"""Gradient compression and explicit all-reduce means over a process group
(port of ``repro.comm``)."""
from repro_torch.comm.compression import (
    compress_with_feedback, compressed_all_reduce_mean, dequantize_int8,
    make_cross_pod_grad_mean, quantize_int8, ring_all_reduce_mean)

__all__ = [
    "quantize_int8", "dequantize_int8", "compress_with_feedback",
    "ring_all_reduce_mean", "compressed_all_reduce_mean",
    "make_cross_pod_grad_mean",
]
