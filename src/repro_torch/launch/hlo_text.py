"""The cost models' shared tables (port of ``repro.launch.hlo_text``).

``DTYPE_BYTES`` (HLO's dtype names, and the same sizes keyed by torch
dtypes), ``COLLECTIVES`` and the ring-formula wire bytes of a collective
are ``repro``'s, copied as they are. The HLO-text parsing there has no
counterpart: the port has no HLO, and its cost count
(:mod:`repro_torch.launch.hlo_cost`) reads the ops of a ``meta`` run.

Ring formulas (per-device wire traffic for a group of size ``n``):

  all-reduce          2 * b * (n-1) / n     (reduce-scatter + all-gather)
  all-gather          b * (n-1) / n         (b = gathered result)
  reduce-scatter      b * (n-1)             (b = scattered shard)
  all-to-all          b * (n-1) / n
  collective-permute  b                     (one neighbour hop)
"""
from __future__ import annotations

import torch

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16, "token": 0, "s4": 1, "u4": 1,
}

# the same sizes by torch dtype
TORCH_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}
TORCH_DTYPE_BYTES = {dt: DTYPE_BYTES[name]
                     for dt, name in TORCH_DTYPE_NAMES.items()}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Per-device wire bytes for one collective under the ring model."""
    if kind == "all-reduce":
        return 2.0 * nbytes * (n - 1) / n
    if kind == "all-gather":
        return nbytes * (n - 1) / n           # result = gathered
    if kind == "reduce-scatter":
        return nbytes * (n - 1)               # result = shard
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    return float(nbytes)                      # collective-permute
