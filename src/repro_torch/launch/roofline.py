"""Roofline terms for the plan tuner (port of ``repro.launch.roofline``'s
:class:`HardwareSpec`, ``HARDWARE``, :class:`RooflineTerms` and
:func:`terms_from_cost`; the HLO text parsing stays in ``repro``: the
port counts its own launches instead, :func:`repro_torch.tune.space.
dryrun_terms`).

Three times (seconds) from counted work:

  T_comp = operations / peak_flops
  T_mem  = bytes / hbm_bw
  T_coll = wire bytes / ici_bw

``h2d_bw`` (host to device) and ``dispatch_us`` (per launch) serve the
tuner's cost model. ``"cuda-h100"`` holds an H100 SXM's data-sheet rates
(float32 outside the tensor cores: the resolve is compare-and-select work
on the CUDA cores); ``"cpu"`` is ``repro``'s coarse stand-in, used only to
rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline rates of one device flavour."""
    name: str
    peak_flops: float          # operations/s of the work's type
    hbm_bw: float              # device memory bytes/s
    ici_bw: float              # bytes/s per link, one direction
    h2d_bw: float = 16e9       # host to device bytes/s
    dispatch_us: float = 3.0   # per-launch overhead, microseconds

    @staticmethod
    def for_backend(backend: str) -> "HardwareSpec":
        """The spec of a device type (``"cuda"``, ``"cpu"``; ``repro``'s
        ``"gpu"`` names the card too); anything else gets ``"cpu"``."""
        key = {"cuda": "cuda-h100", "gpu": "cuda-h100"}.get(backend, "cpu")
        return HARDWARE[key]


HARDWARE: Dict[str, HardwareSpec] = {
    # NVIDIA H100 SXM data sheet: 67 TFLOP/s float32 (non-tensor), HBM3
    # 3.35 TB/s, NVLink 4 450 GB/s a direction, PCIe 5.0 x16 64 GB/s.
    # dispatch_us: the host time of one of the port's kernel launches
    # through its wrapper (a one-lane sweep_partials at N=4096, C=100),
    # chip_smoke.py phase 15 on an NVIDIA H100 80GB HBM3 at 700.00 W:
    # 53.57 µs a launch over 200 launches
    "cuda-h100": HardwareSpec("cuda-h100", 67e12, 3.35e12, 450e9,
                              h2d_bw=64e9, dispatch_us=53.57),
    # a coarse single-socket stand-in (repro's own numbers): only the
    # ranking on this backend uses it, and measurement decides the rest
    "cpu": HardwareSpec("cpu", 0.5e12, 50e9, 50e9, h2d_bw=50e9,
                        dispatch_us=8.0),
}


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    collective_detail: Dict[str, float]
    per_device_memory_bytes: Optional[float] = None
    model_flops: Optional[float] = None
    useful_flops_ratio: Optional[float] = None
    hardware: Optional[str] = None

    @property
    def t_step(self) -> float:
        """Optimistic step time: the binding term (full overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self):
        return dataclasses.asdict(self)


def terms_from_cost(flops: float, nbytes: float, wire_bytes: float,
                    hw: HardwareSpec,
                    collective_detail: Optional[Dict[str, float]] = None,
                    ) -> RooflineTerms:
    """Roofline terms from counted per-device work."""
    t_c = flops / hw.peak_flops
    t_m = nbytes / hw.hbm_bw
    t_x = wire_bytes / hw.ici_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return RooflineTerms(
        flops_per_device=flops, bytes_per_device=nbytes,
        wire_bytes_per_device=wire_bytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=max(terms, key=terms.get),
        collective_detail=dict(collective_detail or {}), hardware=hw.name)
