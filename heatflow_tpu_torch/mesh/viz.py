"""Mesh visualization: a matplotlib cell-tag plot standing in for the
reference's gmsh GUI inspection (ref run_no_diamond.py:183-187).

Works for both the structured tensor grid and imported unstructured
triangulations; produces a PNG artifact so sweeps / headless runs keep a
visual record of the mesh they ran on. matplotlib is imported at first use.
"""

from __future__ import annotations

import numpy as np

from heatflow_tpu_torch.mesh.structured import StructuredMesh
from heatflow_tpu_torch.utils import finish_figure, pyplot


def plot_mesh(mesh, path: str | None = None, *, show: bool = False,
              max_grid_lines: int = 400, dpi: int = 150):
    """Plot material regions (colored by cell tag) with the mesh edges.

    mesh: StructuredMesh or UnstructuredMesh. Returns (fig, ax); saves a PNG
    when ``path`` is given.
    """
    plt = pyplot(show)
    fig, ax = plt.subplots(figsize=(10, 6))
    if isinstance(mesh, StructuredMesh):
        pm = ax.pcolormesh(mesh.z, mesh.r, mesh.cell_tags.T,
                           cmap="tab10", shading="flat",
                           vmin=0.5, vmax=10.5)
        # grid lines (skipped when the grid is too fine to be legible)
        if len(mesh.z) <= max_grid_lines:
            ax.vlines(mesh.z, mesh.r.min(), mesh.r.max(),
                      colors="k", lw=0.15, alpha=0.5)
        if len(mesh.r) <= max_grid_lines:
            ax.hlines(mesh.r, mesh.z.min(), mesh.z.max(),
                      colors="k", lw=0.15, alpha=0.5)
        n_cells = 2 * mesh.num_cells
    else:  # UnstructuredMesh (nodes / cells / cell_tags)
        import matplotlib.tri as mtri
        tri = mtri.Triangulation(mesh.nodes[:, 0], mesh.nodes[:, 1],
                                 mesh.cells)
        pm = ax.tripcolor(tri, facecolors=np.asarray(mesh.cell_tags, float),
                          cmap="tab10", vmin=0.5, vmax=10.5)
        if len(mesh.cells) <= 40000:
            ax.triplot(tri, color="k", lw=0.1, alpha=0.5)
        n_cells = len(mesh.cells)
    tag_names = {t: n for n, t in (mesh.material_tags or {}).items()}

    cbar = fig.colorbar(pm, ax=ax, label="material tag")
    if tag_names:
        ticks = sorted(tag_names)
        cbar.set_ticks(ticks)
        cbar.set_ticklabels([f"{t}: {tag_names[t]}" for t in ticks])
    ax.set_xlabel("z (m)")
    ax.set_ylabel("r (m)")
    ax.set_title(f"mesh: {n_cells} triangles")
    fig.tight_layout()
    finish_figure(fig, path, show, dpi=dpi)
    return fig, ax
