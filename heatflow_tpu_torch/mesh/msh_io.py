"""gmsh ``.msh`` (MSH 2.2 ASCII) writer: meshes persisted by the drivers open
in gmsh. Reading ``.msh`` files (and the unstructured path they feed) is not
ported yet (ROADMAP P9)."""

from __future__ import annotations

import numpy as np


def write_msh(path: str, nodes: np.ndarray, cells: np.ndarray,
              cell_tags: np.ndarray,
              material_tags: dict[str, int] | None = None) -> None:
    """Write an MSH 2.2 ASCII file. ``nodes`` are (N,2) (z,r) → (x,y,0);
    ``cells`` (M,3) triangles or (M,2) lines, 0-based."""
    nodes = np.asarray(nodes, dtype=np.float64)
    cells = np.asarray(cells)
    cell_tags = np.asarray(cell_tags)
    elm_type = {2: 1, 3: 2}[cells.shape[1]]  # 2-node line / 3-node triangle

    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat"]
    if material_tags:
        lines += ["$PhysicalNames", str(len(material_tags))]
        dim = 2 if elm_type == 2 else 1
        for name, tag in sorted(material_tags.items(), key=lambda kv: kv[1]):
            lines.append(f'{dim} {tag} "{name}"')
        lines.append("$EndPhysicalNames")
    lines += ["$Nodes", str(len(nodes))]
    lines += [f"{i} {z:.16e} {r:.16e} 0"
              for i, (z, r) in enumerate(nodes, start=1)]
    lines += ["$EndNodes", "$Elements", str(len(cells))]
    for e, (conn, tag) in enumerate(zip(cells, cell_tags), start=1):
        conn_s = " ".join(str(int(c) + 1) for c in conn)
        lines.append(f"{e} {elm_type} 2 {int(tag)} {int(tag)} {conn_s}")
    lines += ["$EndElements", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
