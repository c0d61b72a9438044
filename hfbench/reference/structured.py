"""Frozen copy of ``heatflow_tpu_torch/mesh/structured.py`` for the plain
reference.

Structured graded tensor-product mesh over a multi-material rectangle stack.

This replaces gmsh (the reference's C++ meshing dependency,
ref: mesh_and_materials/mesh.py:81-149): the mesh is a graded (z, r) tensor
grid; every quad cell is split into two P1 triangles with a consistent
diagonal; material ids live on cells. All arrays are plain numpy at build
time and become device tensors inside the solvers.

Node numbering: node (i, j) -> id = i * Nr + j  (z-major).
Cell (i, j) covers [z_i, z_{i+1}] x [r_j, r_{j+1}] and is split into
  lower triangle: (i, j), (i+1, j), (i+1, j+1)
  upper triangle: (i, j), (i+1, j+1), (i, j+1)
so node couplings form a 7-point stencil: (0,0), (±1,0), (0,±1), (1,1), (-1,-1).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from hfbench.reference.axes import graded_axis
from hfbench.reference.geometry import MaterialSpec, validate_layout


@dataclass
class StructuredMesh:
    z: np.ndarray                       # (Nz,) axial grid lines
    r: np.ndarray                       # (Nr,) radial grid lines
    cell_tags: np.ndarray               # (Nz-1, Nr-1) int32 material tag per quad
    material_tags: dict[str, int]       # material name -> tag (1-based, order)
    materials: list[MaterialSpec] = field(default_factory=list)

    # ------------------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return len(self.z), len(self.r)

    @property
    def num_nodes(self) -> int:
        return len(self.z) * len(self.r)

    @property
    def num_cells(self) -> int:
        return (len(self.z) - 1) * (len(self.r) - 1)

    def node_coords(self) -> np.ndarray:
        """(N, 2) array of (z, r) node coordinates, z-major ordering."""
        zz, rr = np.meshgrid(self.z, self.r, indexing="ij")
        return np.stack([zz.ravel(), rr.ravel()], axis=1)

    def node_id(self, i, j):
        return np.asarray(i) * len(self.r) + np.asarray(j)

    def nearest_node(self, z: float, r: float) -> int:
        """Nearest mesh node to (z, r) — replaces the reference's cKDTree
        watcher lookup (ref: run_no_diamond.py:397-401). On a tensor grid the
        nearest node factorizes per axis."""
        i = int(np.argmin(np.abs(self.z - z)))
        j = int(np.argmin(np.abs(self.r - r)))
        return i * len(self.r) + j

    # ------------------------------------------------------------------
    def triangles(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (tris (M,3) int32 node ids, tri_tags (M,)) for the
        unstructured view of this mesh (two triangles per quad, lower first).
        """
        nz, nr = self.shape
        i, j = np.meshgrid(np.arange(nz - 1), np.arange(nr - 1), indexing="ij")
        n00 = (i * nr + j).ravel()
        n10 = ((i + 1) * nr + j).ravel()
        n11 = ((i + 1) * nr + j + 1).ravel()
        n01 = (i * nr + j + 1).ravel()
        lower = np.stack([n00, n10, n11], axis=1)
        upper = np.stack([n00, n11, n01], axis=1)
        tris = np.concatenate([lower, upper], axis=0).astype(np.int32)
        tags = np.concatenate([self.cell_tags.ravel()] * 2).astype(np.int32)
        return tris, tags

    # ------------------------------------------------------------------
    def to_meta(self) -> dict:
        """Serializable description (stored in mesh_cfg.yaml for reuse)."""
        return {
            "z": [float(v) for v in self.z],
            "r": [float(v) for v in self.r],
            "material_tags": dict(self.material_tags),
        }


def _assign_cell_tags(z: np.ndarray, r: np.ndarray,
                      materials: list[MaterialSpec]) -> np.ndarray:
    zc = 0.5 * (z[:-1] + z[1:])
    rc = 0.5 * (r[:-1] + r[1:])
    zz, rr = np.meshgrid(zc, rc, indexing="ij")
    tags = np.zeros(zz.shape, dtype=np.int32)
    for tag, mat in enumerate(materials, start=1):
        zmin, zmax, rmin, rmax = mat.bounds
        inside = ((zz >= zmin) & (zz <= zmax) & (rr >= rmin) & (rr <= rmax)
                  & (tags == 0))
        tags[inside] = tag
    if np.any(tags == 0):
        bad = np.argwhere(tags == 0)[0]
        raise ValueError(
            "materials do not tile the meshed domain: cell centered at "
            f"(z={zz[tuple(bad)]:.4e}, r={rr[tuple(bad)]:.4e}) is uncovered")
    return tags


def build_structured_mesh(domain_bounds, materials: list[MaterialSpec],
                          *, size_scale: float = 1.0) -> StructuredMesh:
    """Build a graded structured mesh covering the union of material rects.

    The meshed extent is the bounding box of the material union (the
    reference meshes exactly the material surfaces, ref: mesh.py:101-114, so
    nominal domain bounds larger than the union are ignored there too).

    size_scale multiplies every target size (handy for convergence studies
    and quick tests).
    """
    validate_layout(domain_bounds, materials)
    zmin = min(m.bounds[0] for m in materials)
    zmax = max(m.bounds[1] for m in materials)
    rmin = min(m.bounds[2] for m in materials)
    rmax = max(m.bounds[3] for m in materials)

    z_spans = [(m.bounds[0], m.bounds[1], m.mesh_size * size_scale)
               for m in materials]
    r_spans = [(m.bounds[2], m.bounds[3], m.mesh_size * size_scale)
               for m in materials]
    z = graded_axis(zmin, zmax, z_spans)
    r = graded_axis(rmin, rmax, r_spans)

    cell_tags = _assign_cell_tags(z, r, materials)
    material_tags = {m.name: t for t, m in enumerate(materials, start=1)}
    return StructuredMesh(z=z, r=r, cell_tags=cell_tags,
                          material_tags=material_tags,
                          materials=list(materials))


def mesh_from_meta(meta: dict, materials: list[MaterialSpec] | None = None
                   ) -> StructuredMesh:
    """Reconstruct a StructuredMesh saved by :meth:`StructuredMesh.to_meta`;
    the cell tags are re-derived from ``materials``."""
    z = np.asarray(meta["z"], dtype=np.float64)
    r = np.asarray(meta["r"], dtype=np.float64)
    mats = list(materials or [])
    if not mats:
        raise ValueError("mesh_from_meta requires the material list to "
                         "re-derive cell tags")
    return StructuredMesh(z=z, r=r, cell_tags=_assign_cell_tags(z, r, mats),
                          material_tags=dict(meta["material_tags"]),
                          materials=mats)
