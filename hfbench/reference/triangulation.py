"""Frozen copy of ``heatflow_tpu_torch/mesh/unstructured_gen.py`` for the
plain reference: the graded non-grid triangulation of a material stack,
the analogue of the upstream project's gmsh meshes (graded unstructured
triangles from per-material Box size fields under a Min field, ref
mesh_and_materials/mesh.py:81-149). It imports nothing of the program.

It builds the mesh of a configuration whose file names
``{"kind": "triangulation"}`` (see ``harness.MESH_KINDS``): the one that
``run2d --mesh-style unstructured`` runs, at ``JITTER`` and ``SEED``.

The triangulation, from the graded grid (per-region sizes = gmsh's
Min-field grading):

  1. jitter every node that does not lie on a material interface or the
     domain boundary (those are pinned in the interface-normal axis, as
     gmsh respects the CAD edges);
  2. split each quad along a randomly chosen diagonal;
  3. randomly permute node and cell numbering.

The draws come from ``np.random.default_rng(seed)`` in the program's
order, so both build bitwise the same mesh from a seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hfbench.reference.geometry import MaterialSpec
from hfbench.reference.structured import (StructuredMesh,
                                          build_structured_mesh)

# the triangulation that ``run2d --mesh-style unstructured`` builds (the
# port's ``build_unstructured_mesh`` defaults); no deployment sets either
JITTER = 0.25
SEED = 0


@dataclass
class Triangulation:
    nodes: np.ndarray                   # (N, 2) (z, r), permuted numbering
    cells: np.ndarray                   # (M, 3) int32 node ids
    cell_tags: np.ndarray               # (M,) int32 material tag per cell


def _pinned(axis_vals: np.ndarray, pinned_coords: set[float],
            tol: float = 1e-15) -> np.ndarray:
    """(N,) bool — grid lines that coincide with a pinned coordinate."""
    pins = np.asarray(sorted(pinned_coords), dtype=np.float64)
    if len(pins) == 0:
        return np.zeros(len(axis_vals), dtype=bool)
    d = np.abs(axis_vals[:, None] - pins[None, :]).min(axis=1)
    scale = max(abs(axis_vals[0]), abs(axis_vals[-1]), 1.0)
    return d <= tol * scale + 1e-300


def _room(axis: np.ndarray) -> np.ndarray:
    """Per grid line, the smaller adjacent spacing."""
    d = np.diff(axis)
    out = np.empty(len(axis))
    out[0] = d[0]
    out[-1] = d[-1]
    out[1:-1] = np.minimum(d[:-1], d[1:])
    return out


def perturb_structured_mesh(mesh: StructuredMesh, *, jitter: float,
                            seed: int) -> Triangulation:
    """The structured mesh as a perturbed, renumbered triangulation.

    jitter: max displacement as a fraction of the smaller adjacent grid
    spacing per axis (<= 0.3 keeps all triangles valid). Nodes on material
    interfaces and domain boundaries are pinned in the interface-normal
    axis, so cell tags remain exact.
    """
    if not 0.0 <= jitter <= 0.3:
        raise ValueError("jitter must be in [0, 0.3] to guarantee validity")
    rng = np.random.default_rng(seed)
    z, r = mesh.z, mesh.r
    nz, nr = mesh.shape

    pinned_z = {b for m in mesh.materials for b in m.bounds[:2]}
    pinned_z |= {float(z[0]), float(z[-1])}
    pinned_r = {b for m in mesh.materials for b in m.bounds[2:]}
    pinned_r |= {float(r[0]), float(r[-1])}
    room_z = _room(z) * ~_pinned(z, pinned_z)
    room_r = _room(r) * ~_pinned(r, pinned_r)

    zz, rr = np.meshgrid(z, r, indexing="ij")
    dz = rng.uniform(-jitter, jitter, (nz, nr)) * room_z[:, None]
    dr = rng.uniform(-jitter, jitter, (nz, nr)) * room_r[None, :]
    nodes = np.stack([(zz + dz).ravel(), (rr + dr).ravel()], axis=1)

    # random diagonal per quad: 0 → (00,10,11)+(00,11,01),
    # 1 → (00,10,01)+(10,11,01)
    i, j = np.meshgrid(np.arange(nz - 1), np.arange(nr - 1), indexing="ij")
    n00 = (i * nr + j).ravel()
    n10 = ((i + 1) * nr + j).ravel()
    n11 = ((i + 1) * nr + j + 1).ravel()
    n01 = (i * nr + j + 1).ravel()
    flip = rng.random(n00.shape) < 0.5
    t1 = np.where(flip[:, None], np.stack([n00, n10, n01], axis=1),
                  np.stack([n00, n10, n11], axis=1))
    t2 = np.where(flip[:, None], np.stack([n10, n11, n01], axis=1),
                  np.stack([n00, n11, n01], axis=1))
    tris = np.concatenate([t1, t2], axis=0).astype(np.int64)
    tags = np.concatenate([mesh.cell_tags.ravel()] * 2).astype(np.int32)

    # validity: all triangles must keep positive signed area
    p = nodes[tris]
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    if det.min() <= 0:
        raise RuntimeError(
            f"perturbation produced {int((det <= 0).sum())} degenerate or "
            f"inverted triangles (min det {det.min():.3e}); lower jitter")

    node_perm = rng.permutation(len(nodes))
    inv = np.empty_like(node_perm)
    inv[node_perm] = np.arange(len(nodes))
    nodes = nodes[node_perm]
    tris = inv[tris]
    cell_perm = rng.permutation(len(tris))
    tris, tags = tris[cell_perm], tags[cell_perm]
    return Triangulation(nodes=nodes, cells=tris.astype(np.int32),
                         cell_tags=tags)


def build_triangulation(domain_bounds, materials: list[MaterialSpec], *,
                        size_scale: float = 1.0, jitter: float = JITTER,
                        seed: int = SEED) -> Triangulation:
    """Graded non-grid triangulation of a material stack (the gmsh-mesh
    analogue, ref mesh_and_materials/mesh.py:81-149)."""
    grid = build_structured_mesh(domain_bounds, materials,
                                 size_scale=size_scale)
    return perturb_structured_mesh(grid, jitter=jitter, seed=seed)
