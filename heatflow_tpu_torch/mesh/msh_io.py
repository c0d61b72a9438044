"""gmsh ``.msh`` reader/writer: meshes persisted by the drivers open in gmsh,
and gmsh meshes (MSH 2.2 or 4.1 ASCII, the reference toolchain's output,
ref run_no_diamond.py:190-195) import through the unstructured path.

Only what the pipeline needs: 2D triangle meshes with physical surface tags
(and 1D line meshes for the reduced model).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class UnstructuredMesh:
    """An imported or generated mesh: nodes + simplices + per-cell tags.

    ``grid_overlay``: when the mesh *topology* embeds in a 2D lattice (node
    positions jittered, diagonals mixed: only the neighbour graph matters),
    ``{"shape": (nzg, nrg), "index": (N,) flat lattice id of each node}``.
    The assembled operator is then a permuted 9-point stencil
    (``ops/overlay.py``), which the CUDA kernels solve; persisted as a
    ``mesh_overlay.npz`` sidecar. Construct it from plain arrays, as the
    JAX package's mesh holds them, with the dataclass itself.
    """

    nodes: np.ndarray               # (N, 2) (z, r)
    cells: np.ndarray               # (M, 3) triangles (or (M, 2) lines in 1D)
    cell_tags: np.ndarray           # (M,)
    material_tags: dict[str, int] = field(default_factory=dict)
    grid_overlay: dict | None = None

    @property
    def dim(self) -> int:
        return self.cells.shape[1] - 1


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


def _physical_names(txt, section) -> dict[str, int]:
    material_tags: dict[str, int] = {}
    i = section("PhysicalNames")
    if i is not None:
        for k in range(int(txt[i + 1])):
            parts = txt[i + 2 + k].split(maxsplit=2)
            material_tags[parts[2].strip().strip('"')] = int(parts[1])
    return material_tags


def _mesh_of(path, coords, tris, tri_tags, lines_, line_tags,
             material_tags) -> UnstructuredMesh:
    """Triangles if there are any, else lines."""
    for conn, tags in ((tris, tri_tags), (lines_, line_tags)):
        if conn:
            return UnstructuredMesh(nodes=coords,
                                    cells=np.asarray(conn, dtype=np.int32),
                                    cell_tags=np.asarray(tags,
                                                         dtype=np.int32),
                                    material_tags=material_tags)
    raise ValueError(f"{path}: no triangles or lines found")


def read_msh(path: str) -> UnstructuredMesh:
    """Read an MSH ASCII file, version 2.2 or 4.1 (triangles preferred,
    else lines). Modern gmsh, the reference's mesh writer (ref
    mesh_and_materials/mesh.py:191-197), emits 4.1 by default; older setups
    emit 2.2."""
    with open(path) as f:
        txt = f.read().split("\n")

    def section(name):
        for i, line in enumerate(txt):
            if line.strip() == f"${name}":
                return i
        return None

    i = section("MeshFormat")
    if i is None:
        raise ValueError(f"{path}: missing $MeshFormat")
    version = txt[i + 1].split()[0]
    if version.startswith("4"):
        return _read_msh4(path, txt, section)
    if not version.startswith("2.2"):
        raise ValueError(f"{path}: unsupported MSH version {version} "
                         "(2.2 and 4.1 ASCII are supported)")
    material_tags = _physical_names(txt, section)

    i = section("Nodes")
    n = int(txt[i + 1])
    coords = np.empty((n, 2), dtype=np.float64)
    id_to_idx: dict[int, int] = {}
    for k in range(n):
        parts = txt[i + 2 + k].split()
        id_to_idx[int(parts[0])] = k
        coords[k] = (float(parts[1]), float(parts[2]))

    i = section("Elements")
    tris, tri_tags, lines_, line_tags = [], [], [], []
    for k in range(int(txt[i + 1])):
        parts = [int(p) for p in txt[i + 2 + k].split()]
        etype, ntags = parts[1], parts[2]
        tags = parts[3:3 + ntags]
        conn = [id_to_idx[c] for c in parts[3 + ntags:]]
        phys = tags[0] if tags else 0
        if etype == 2:
            tris.append(conn)
            tri_tags.append(phys)
        elif etype == 1:
            lines_.append(conn)
            line_tags.append(phys)
    return _mesh_of(path, coords, tris, tri_tags, lines_, line_tags,
                    material_tags)


def _read_msh4(path: str, txt: list[str], section) -> UnstructuredMesh:
    """MSH 4.1 ASCII: entity-blocked nodes and elements; an element's
    physical tag comes from its owning entity ($Entities)."""
    material_tags = _physical_names(txt, section)

    # (dim, entityTag) → first physical tag
    ent_phys: dict[tuple[int, int], int] = {}
    i = section("Entities")
    if i is not None:
        counts = [int(v) for v in txt[i + 1].split()]
        row = i + 2
        for dim, cnt in enumerate(counts):
            for _ in range(cnt):
                parts = txt[row].split()
                row += 1
                # points: tag x y z numPhys …; others: tag 6×bbox numPhys …
                off = 4 if dim == 0 else 7
                if int(parts[off]):
                    ent_phys[(dim, int(parts[0]))] = int(parts[off + 1])

    i = section("Nodes")
    header = txt[i + 1].split()
    nblocks, nnodes = int(header[0]), int(header[1])
    coords = np.empty((nnodes, 2), dtype=np.float64)
    id_to_idx: dict[int, int] = {}
    row, idx = i + 2, 0
    for _ in range(nblocks):
        nb = int(txt[row].split()[3])
        row += 1
        tags = [int(txt[row + k]) for k in range(nb)]
        row += nb
        for k in range(nb):
            parts = txt[row].split()
            row += 1
            id_to_idx[tags[k]] = idx
            coords[idx] = (float(parts[0]), float(parts[1]))
            idx += 1

    i = section("Elements")
    nblocks = int(txt[i + 1].split()[0])
    row = i + 2
    tris, tri_tags, lines_, line_tags = [], [], [], []
    for _ in range(nblocks):
        dim, etag, etype, nb = (int(v) for v in txt[row].split())
        row += 1
        phys = ent_phys.get((dim, etag), 0)
        for _ in range(nb):
            conn = [id_to_idx[int(v)] for v in txt[row].split()[1:]]
            row += 1
            if etype == 2:
                tris.append(conn)
                tri_tags.append(phys)
            elif etype == 1:
                lines_.append(conn)
                line_tags.append(phys)
    return _mesh_of(path, coords, tris, tri_tags, lines_, line_tags,
                    material_tags)
