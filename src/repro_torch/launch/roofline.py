"""Roofline terms for the plan tuner and the dry run (port of
``repro.launch.roofline``: :class:`HardwareSpec`, ``HARDWARE``,
:class:`RooflineTerms`, :func:`terms_from_cost`, :func:`roofline` and
:func:`model_flops_estimate`; the HLO text parsing has no counterpart:
the tuner counts its own launches, :func:`repro_torch.tune.space.
dryrun_terms`, and the dry run counts a ``meta`` run,
:mod:`repro_torch.launch.hlo_cost`).

Three times (seconds) from counted work:

  T_comp = operations / peak_flops
  T_mem  = bytes / hbm_bw
  T_coll = wire bytes / ici_bw

``h2d_bw`` (host to device) and ``dispatch_us`` (per launch) serve the
tuner's cost model. ``"cuda-h100"`` holds an H100 SXM's data-sheet rates
(float32 outside the tensor cores: the resolve is compare-and-select work
on the CUDA cores); ``"cpu"`` is ``repro``'s coarse stand-in, used only to
rank. The dry run's LM cells take :data:`H100_TENSOR_CORES`
(``"cuda-h100-tc"``, not among the tuner's ``HARDWARE``): their products
are bfloat16 on the tensor cores (:func:`roofline` takes the rest of
their operations at ``"cuda-h100"``'s CUDA-core rate).

**Links a mesh axis gets** (:func:`axis_bandwidth`). An H100 SXM node
holds 8 cards on NVLink 4 (450 GB/s a direction a card); nodes meet over
InfiniBand NDR, one 400 Gb/s adapter a card (50 GB/s a direction). The
mesh is laid out row-major over nodes of 8 consecutive positions, so an
axis whose every group of ranks lies in one node (the 2×2 test mesh)
rings over NVLink, and any other over InfiniBand, its slowest hop: on the
16×16 production mesh the ``model`` axis (16 consecutive cards) spans two
nodes and ``data`` (a stride of 16) sixteen, so both get 50 GB/s, as does
``pod``. All data-sheet rates; none was measured.
"""
from __future__ import annotations

import dataclasses
import itertools
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


# NVIDIA H100 SXM data sheet: 989 TFLOP/s bfloat16 on the tensor cores,
# dense (1,979 with 2:4 sparsity); the same HBM3 and NVLink
H100_TENSOR_CORES = HardwareSpec("cuda-h100-tc", 989e12, 3.35e12, 450e9,
                                 h2d_bw=64e9, dispatch_us=53.57)


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


NODE_GPUS = 8              # cards an NVLink node holds (HGX H100)
INTER_NODE_BW = 50e9       # InfiniBand NDR, 400 Gb/s a card, one direction


def axis_bandwidth(mesh, axes, hw: HardwareSpec) -> float:
    """Bytes/s of a ring over the mesh ``axes`` (a name or a tuple):
    ``hw.ici_bw`` (NVLink) where every group of ranks lies in one node of
    :data:`NODE_GPUS` consecutive row-major positions, else
    :data:`INTER_NODE_BW`."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names, sizes = list(mesh.axis_names), list(mesh.sizes)
    nodes: Dict[tuple, set] = {}
    for linear, coords in enumerate(itertools.product(
            *(range(n) for n in sizes))):
        key = tuple(c for a, c in zip(names, coords) if a not in axes)
        nodes.setdefault(key, set()).add(linear // NODE_GPUS)
    fits = all(len(v) == 1 for v in nodes.values())
    return hw.ici_bw if fits else INTER_NODE_BW


def roofline(cost, *, model_flops_per_device: Optional[float] = None,
             hw: Optional[HardwareSpec] = None, mesh=None,
             memory_bytes: Optional[float] = None) -> RooflineTerms:
    """The three terms of a per-device :class:`~repro_torch.launch.
    hlo_cost.Cost`: T_comp its products at ``hw.peak_flops`` (the tensor
    cores, ``"cuda-h100-tc"`` by default) and its other operations at the
    CUDA cores' float32 rate; T_mem its bytes over ``hw.hbm_bw``; T_coll
    each mesh axis' wire bytes over that axis' link
    (:func:`axis_bandwidth`; ``hw.ici_bw`` without a mesh)."""
    hw = hw or H100_TENSOR_CORES
    other = max(cost.flops - cost.product_flops, 0.0)
    t_c = (cost.product_flops / hw.peak_flops
           + other / HARDWARE["cuda-h100"].peak_flops)
    t_m = cost.bytes / hw.hbm_bw
    t_x = sum(wire / (axis_bandwidth(mesh, tuple(key.split("+")), hw)
                      if mesh is not None else hw.ici_bw)
              for key, wire in cost.coll_by_axis.items())
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    out = RooflineTerms(
        flops_per_device=cost.flops, bytes_per_device=cost.bytes,
        wire_bytes_per_device=cost.coll_wire_bytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=max(terms, key=terms.get),
        collective_detail=dict(cost.coll_by_kind), hardware=hw.name,
        per_device_memory_bytes=memory_bytes)
    out.model_flops = model_flops_per_device
    if model_flops_per_device and cost.flops > 0:
        out.useful_flops_ratio = model_flops_per_device / cost.flops
    return out


def model_flops_estimate(n_params_active: int, tokens: int) -> float:
    """The 6*N*D convention (fwd+bwd); callers pass fwd-only tokens/3 for
    inference shapes."""
    return 6.0 * float(n_params_active) * float(tokens)
