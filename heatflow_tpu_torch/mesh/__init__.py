from heatflow_tpu_torch.mesh.axes import graded_axis
from heatflow_tpu_torch.mesh.structured import (StructuredMesh,
                                                build_structured_mesh,
                                                mesh_from_meta)

__all__ = ["StructuredMesh", "build_structured_mesh", "graded_axis",
           "mesh_from_meta"]
