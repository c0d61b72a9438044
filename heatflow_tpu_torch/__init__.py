"""heatflow_tpu_torch — the PyTorch/CUDA port of heatflow_tpu.

Transient axisymmetric heat conduction in laser-heated diamond-anvil-cell
(DAC) experiments: config → layout → structured mesh → per-material P1
stencils → ``Problem2D`` → backward-Euler steps solved by preconditioned CG,
eager PyTorch on any device, for one run (``sim.stepper``) or a batch of
coefficient-sweep configs (``sim.sweepkernel``), with solves that are
differentiable by implicit differentiation for the gradient-based fit
(``drivers.fit``). Unstructured triangle meshes (gmsh ``.msh`` or
generated, ``sim.unstructured``) run on ELL operators, or, when their
topology embeds in a lattice, on its 9-point stencils. On an NVIDIA H100
the solves go through hand-written CUDA kernels (``csrc/cg_tol.cu``,
``csrc/sweep_cg.cu``, built with ``nvcc`` at first use). Importing the package loads no CUDA library and builds nothing.
"""

__version__ = "0.1.0"

from heatflow_tpu_torch.config import load_config
from heatflow_tpu_torch.geometry import MaterialSpec, build_layout
from heatflow_tpu_torch.mesh.structured import build_structured_mesh

__all__ = [
    "load_config",
    "build_layout",
    "MaterialSpec",
    "build_structured_mesh",
    "__version__",
]
