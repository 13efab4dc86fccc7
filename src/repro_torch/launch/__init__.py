"""Command-line entry points and device meshes (port of ``repro.launch``)."""
from repro_torch.launch.mesh import (SweepMeshSpec, data_axes,
                                     distributed_initialize, make_mesh)

__all__ = ["make_mesh", "data_axes", "SweepMeshSpec",
           "distributed_initialize"]
