"""Elastic scaling: remesh and a resharded restart after membership
changes (port of ``repro.fault.elastic``).

The contract: training state is checkpointed as *logical* tensors
(:mod:`repro_torch.checkpoint`). On a membership change (failure,
preemption, scale-up) the driver

1. picks the new mesh from the surviving device count (the largest
   (data, model) grid with the model axis kept: the tensor-parallel
   degree is a program invariant, data parallelism shrinks or grows);
2. restores the latest checkpoint onto it (restore places logical
   tensors, so no resharding pass is needed);
3. resumes from the checkpointed step, rescaling gradient accumulation so
   the global batch stays constant (microbatches x data parallel =
   const).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.device import DeviceLike
from repro_torch.launch.mesh import Mesh, make_mesh


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    microbatches: int


def plan_remesh(n_devices: int, model_parallel: int,
                global_batch: int, ref_microbatches: int,
                ref_data_parallel: int) -> ElasticPlan:
    """The largest usable mesh with a fixed model-parallel degree;
    gradient accumulation makes up for lost data parallelism so the
    global batch is unchanged."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep TP={model_parallel} with {n_devices} devices")
    data_parallel = n_devices // model_parallel
    # keep the global batch: mb * dp = ref_mb * ref_dp
    total = ref_microbatches * ref_data_parallel
    microbatches = max(1, total // data_parallel)
    # data_parallel must divide the global batch
    while global_batch % data_parallel != 0 and data_parallel > 1:
        data_parallel -= 1
        microbatches = max(1, total // data_parallel)
    return ElasticPlan(mesh_shape=(data_parallel, model_parallel),
                       axis_names=("data", "model"),
                       microbatches=microbatches)


def build_mesh(plan: ElasticPlan, *,
               devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """The plan's mesh over ``devices`` (every visible CUDA card by
    default; a device may be named more than once, as ``["cpu"] * 4``)."""
    return make_mesh(plan.mesh_shape, plan.axis_names, devices=devices)
