"""Command-line entry points and device meshes (port of ``repro.launch``)."""
from repro_torch.launch.mesh import (LogicalMesh, SweepMeshSpec, data_axes,
                                     distributed_initialize, make_mesh,
                                     make_production_mesh)

__all__ = ["make_mesh", "make_production_mesh", "LogicalMesh", "data_axes",
           "SweepMeshSpec", "distributed_initialize"]
