"""The 1D reduced model: r=0 axis submesh + radial-correction source term.

Reproduces run_no_diamond_1d.py's physics:

  * extract the r=0 axis of a 2D mesh as a 1D submesh with material tags
    transferred from the adjacent 2D cells (ref :30-164 — trivial on a
    structured mesh: the axis IS the z grid, tags are the j=0 cell column);
  * 1D backward Euler with *unweighted* forms (ref :537-546);
  * Dirichlet: both ends at ic_temp, heating value at
    heating_z = mesh_zmin + z_ins_pside (ref :568-588);
  * optional radial-correction source S = 2 κ (∂T/∂r)/Δr interpolated from a
    2D run's radial-gradient CSV in (t, z), clamped to the data range with a
    0.1x damping at z-clamped nodes (ref :717-747); Δr = 0.1 µm for smoothed
    data, 0.07 µm for raw (ref :469-480).

Each implicit step is an exact tridiagonal Thomas solve (ops/tridiag.py),
its elimination factored once per run. The step times are known before the
loop starts, so the boundary values and the source of every step are formed
in one batch of device operations ahead of it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from heatflow_tpu_torch.mesh.structured import StructuredMesh
from heatflow_tpu_torch.ops.tridiag import (apply_tridiag, assemble_1d,
                                            combine_tridiag,
                                            dirichlet_operator, dirichlet_rhs,
                                            thomas_apply, thomas_factor)
from heatflow_tpu_torch.sim.stepper import interp
from heatflow_tpu_torch.utils import resolve_device

DELTA_R_SMOOTHED = 0.1e-6   # ref run_no_diamond_1d.py:476
DELTA_R_RAW = 0.07e-6       # ref :478
BOUNDARY_DAMPING = 0.1      # ref :740


def extract_axis_submesh(mesh: StructuredMesh):
    """(z (Nz,), cell_tags_1d (Nz-1,)) — the r=0 line of a structured mesh.

    Tag transfer: each axis interval inherits the tag of the 2D cell touching
    it from above (j=0 column), matching the reference's
    'first containing 2D cell' rule (ref run_no_diamond_1d.py:124-138).
    """
    return mesh.z.copy(), mesh.cell_tags[:, 0].copy()


def extract_axis_submesh_unstructured(umesh, tolerance: float = 1e-10):
    """(z (Nz,), cell_tags_1d (Nz-1,)) — the r=0 axis of an *unstructured*
    triangle mesh (any object with ``nodes`` (N, 2) as (z, r), ``cells``
    (M, 3) and ``cell_tags`` (M,)), the reference's submesh extraction
    re-expressed as pure index selection (ref run_no_diamond_1d.py:30-164):

      * facet scan: an edge belongs to the axis iff BOTH endpoints have
        |r| <= tolerance (ref :70-90);
      * tag transfer: each axis edge inherits the tag of the first
        (lowest-index) 2D cell containing it (ref :124-138 — dolfinx's
        facet_to_cells lists cells in ascending index order and the
        reference takes element [0]);
      * the 1D mesh is the axis edges ordered by z.
    """
    nodes = np.asarray(umesh.nodes, dtype=np.float64)
    cells = np.asarray(umesh.cells)
    ctags = np.asarray(umesh.cell_tags)
    on_axis = np.abs(nodes[:, 1]) <= tolerance

    # all triangle edges with their owning cell
    e = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                        cells[:, [2, 0]]], axis=0)
    owner = np.tile(np.arange(len(cells)), 3)
    sel = on_axis[e[:, 0]] & on_axis[e[:, 1]]
    if not sel.any():
        raise ValueError(
            "No facets found on the r=0 axis. Check tolerance or mesh.")
    e, owner = e[sel], owner[sel]

    # unique edges; first-containing-cell = min owner per edge
    key_pair = np.sort(e, axis=1)
    key = key_pair[:, 0].astype(np.int64) * len(nodes) + key_pair[:, 1]
    order = np.lexsort((owner, key))       # sort by key, then owner ascending
    key, owner, key_pair = key[order], owner[order], key_pair[order]
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    edges = key_pair[first]                # (Ne, 2) node ids
    tags = ctags[owner[first]]

    # order edges along z and stitch the 1D node chain
    mid = 0.5 * (nodes[edges[:, 0], 0] + nodes[edges[:, 1], 0])
    zorder = np.argsort(mid)
    edges, tags = edges[zorder], tags[zorder]
    lo = np.where(nodes[edges[:, 0], 0] <= nodes[edges[:, 1], 0],
                  edges[:, 0], edges[:, 1])
    hi = np.where(nodes[edges[:, 0], 0] <= nodes[edges[:, 1], 0],
                  edges[:, 1], edges[:, 0])
    if not np.all(hi[:-1] == lo[1:]):
        raise ValueError("axis facets do not form a single connected chain")
    z = np.concatenate([nodes[lo, 0], nodes[hi[-1:], 0]])
    return z, tags.copy()


def node_kappas_1d(z: np.ndarray, cell_tags: np.ndarray,
                   kappas: np.ndarray) -> np.ndarray:
    """Per-node conductivity via the reference's node→cell rule: the first
    (lowest-index) cell whose z-range contains the node — cell i-1 for node
    i >= 1, cell 0 for node 0 (ref run_no_diamond_1d.py:678-697)."""
    cell_idx = np.maximum(np.arange(len(z)) - 1, 0)
    return np.asarray(kappas)[np.asarray(cell_tags)[cell_idx] - 1]


@dataclass
class GradientTable:
    """A radial-gradient CSV loaded for (t, z) interpolation."""
    times: np.ndarray       # (T,)
    z: np.ndarray           # (Z,)
    values: np.ndarray      # (T, Z)
    delta_r: float

    @classmethod
    def from_csv(cls, path: str) -> "GradientTable":
        from heatflow_tpu_torch.io.csvio import read_gradient_csv
        times, z, values = read_gradient_csv(path)
        smoothed = path.endswith("radial_gradient.csv") or \
            "radial_gradient_raw" not in path
        return cls(times=times, z=z, values=values,
                   delta_r=DELTA_R_SMOOTHED if smoothed else DELTA_R_RAW)


def make_source_fn(table: GradientTable, z_nodes: np.ndarray,
                   node_kappa: np.ndarray, dtype: torch.dtype = torch.float64,
                   device="cuda"):
    """S(t) -> (..., Nz) radial-correction source for times t (...,), on
    ``device`` (the card unless the caller passes ``device='cpu'``).

    Bilinear (t, z) interpolation with clamping + 0.1x damping at z-clamped
    nodes; S = 2 κ grad / Δr (ref run_no_diamond_1d.py:717-747). In time: the
    knot interval is the last one whose left knot is ≤ t (the last interval
    at and past the final knot); in z: linear between knots, the end values
    outside them.
    """
    device = resolve_device(device)
    as_t = lambda v: torch.as_tensor(np.array(v), dtype=dtype,
                                     device=device)
    gt, gz, gv = as_t(table.times), as_t(table.z), as_t(table.values)
    zn, kap = as_t(z_nodes), as_t(node_kappa)
    inv_dr = as_t(2.0 / table.delta_r)
    z_cl = torch.clamp(zn, gz[0], gz[-1])
    damp = torch.where(zn != z_cl, as_t(BOUNDARY_DAMPING), as_t(1.0))
    n_t = len(table.times)

    def source(t):
        t = torch.as_tensor(t, dtype=dtype, device=device)
        t_cl = torch.clamp(t, gt[0], gt[-1])
        it = torch.clamp(torch.searchsorted(gt, t_cl.reshape(-1), right=True)
                         .reshape(t_cl.shape) - 1, 0, n_t - 2)
        w = ((t_cl - gt[it])
             / torch.clamp(gt[it + 1] - gt[it], min=1e-300))[..., None]
        row = (1.0 - w) * gv[it] + w * gv[it + 1]
        # interp puts the rows' leading dimensions first: (..., Nz)
        grad = interp(z_cl, gz, row)
        return kap * grad * damp * inv_dr

    return source


@dataclass
class Problem1D:
    z: np.ndarray
    cell_tags: np.ndarray
    material_tags: dict[str, int]
    kappas: np.ndarray
    rho_cvs: np.ndarray
    dt: float
    num_steps: int
    ic_temp: float
    heating_z: float
    heat_time: np.ndarray
    heat_temp: np.ndarray
    gradient: GradientTable | None = None

    @property
    def heat_node(self) -> int:
        return int(np.argmin(np.abs(self.z - self.heating_z)))


def build_problem_1d(mesh, heating, cfg, *,
                     gradient: GradientTable | None = None) -> Problem1D:
    """Build the 1D reduced problem from either mesh kind. For a
    StructuredMesh the axis is the z grid; for an unstructured triangle mesh
    (``nodes``, ``cells``, ``cell_tags``, ``material_tags``) the axis submesh
    is extracted facet-by-facet (the reference's case,
    ref run_no_diamond_1d.py:30-164) and material properties come from the
    config via the mesh's name→tag map."""
    from heatflow_tpu_torch.config import mat_float
    if isinstance(mesh, StructuredMesh):
        z, tags = extract_axis_submesh(mesh)
        material_tags = dict(mesh.material_tags)
        kappas = np.array([m.kappa for m in mesh.materials])
        rho_cvs = np.array([m.rho_cv for m in mesh.materials])
    else:
        z, tags = extract_axis_submesh_unstructured(mesh)
        material_tags = dict(mesh.material_tags)
        if not material_tags:
            raise ValueError("unstructured mesh lacks material name→tag map")
        order = sorted(material_tags.items(), key=lambda kv: kv[1])
        if [t for _, t in order] != list(range(1, len(order) + 1)):
            raise ValueError(f"material tags must be 1..n: {material_tags}")
        kappas = np.array([mat_float(cfg, nm, "k") for nm, _ in order])
        rho_cvs = np.array([mat_float(cfg, nm, "rho")
                            * mat_float(cfg, nm, "cv") for nm, _ in order])
    # heating location: p-side insulator/coupler interface
    # (ref run_no_diamond_1d.py:568-569)
    z_sample = mat_float(cfg, "p_sample", "z")
    z_ins_pside = mat_float(cfg, "p_ins", "z")
    z_coupler = mat_float(cfg, "p_coupler", "z")
    mesh_zmin = -(z_sample / 2) - z_ins_pside - z_coupler
    heating_z = mesh_zmin + z_ins_pside
    t_final = float(cfg["timing"]["t_final"])
    num_steps = int(cfg["timing"]["num_steps"])
    return Problem1D(
        z=z, cell_tags=tags, material_tags=material_tags,
        kappas=kappas, rho_cvs=rho_cvs,
        dt=t_final / num_steps, num_steps=num_steps,
        ic_temp=float(cfg["heating"]["ic_temp"]), heating_z=heating_z,
        heat_time=np.asarray(heating.time, float),
        heat_temp=np.asarray(heating.temp, float),
        gradient=gradient)


def make_simulate_fn_1d(problem: Problem1D, *,
                        dtype: torch.dtype = torch.float64,
                        use_radial_correction: bool = True,
                        record_fields: bool = False,
                        watcher_z: dict[str, float] | None = None,
                        device="cuda"):
    """simulate(kappas, rho_cvs) -> traces for the 1D model, on ``device``
    (the card unless the caller passes ``device='cpu'``).

    The result holds ``times`` (S,), ``final_u`` (..., Nz) and, when asked
    for, ``watch`` (..., S, W) and ``field`` (..., S, Nz), as tensors on
    ``device``; leading dimensions of ``kappas`` / ``rho_cvs``
    (..., n_mats) run a batch of coefficient sets through the same steps."""
    device = resolve_device(device)
    z = problem.z
    nz = len(z)
    n_mats = len(problem.material_tags)
    st = assemble_1d(z, problem.cell_tags, n_mats)
    as_t = lambda v: torch.as_tensor(np.array(v), dtype=dtype,
                                     device=device)
    K, M, M_unit = as_t(st["K"]), as_t(st["M"]), as_t(st["M_unit"])
    dt, ic = as_t(problem.dt), as_t(problem.ic_temp)

    heat_t, heat_T = as_t(problem.heat_time), as_t(problem.heat_temp)
    amp_offset = heat_T[0] - ic

    bc_mask = np.zeros(nz)
    bc_mask[0] = bc_mask[-1] = 1.0
    bc_mask[problem.heat_node] = 1.0
    heat_sel = np.zeros(nz)
    heat_sel[problem.heat_node] = 1.0
    bc_mask, heat_sel = as_t(bc_mask), as_t(heat_sel)

    if use_radial_correction and problem.gradient is not None:
        node_kap = node_kappas_1d(z, problem.cell_tags, problem.kappas)
        source_fn = make_source_fn(problem.gradient, z, node_kap, dtype,
                                   device)
    else:
        source_fn = None

    watch_idx = None
    names: list[str] = []
    if watcher_z:
        names = list(watcher_z.keys())
        watch_idx = torch.as_tensor(
            [int(np.argmin(np.abs(z - zq))) for zq in watcher_z.values()],
            device=device)

    @torch.no_grad()
    def simulate(kappas=None, rho_cvs=None):
        kp = as_t(problem.kappas if kappas is None else kappas)
        rc = as_t(problem.rho_cvs if rho_cvs is None else rho_cvs)
        A, M_op = combine_tridiag(K, M, kp, rc, dt)
        factor = thomas_factor(dirichlet_operator(A, bc_mask))

        ts = torch.arange(1, problem.num_steps + 1, dtype=dtype,
                          device=device) * dt
        # 1D heating is the raw amplitude (no Gaussian), ref :573-575
        amp = interp(ts, heat_t, heat_T) - amp_offset
        bc_values = ic * bc_mask + (amp - ic)[:, None] * heat_sel
        src = None
        if source_fn is not None:
            src = dt * apply_tridiag(M_unit, source_fn(ts))

        u = torch.full(A.shape[:-2] + (nz,), float(problem.ic_temp),
                       dtype=dtype, device=device)
        watch, fields = [], []
        for s in range(problem.num_steps):
            b = apply_tridiag(M_op, u)
            if src is not None:
                b = b + src[s]
            u = thomas_apply(factor, dirichlet_rhs(A, b, bc_mask,
                                                   bc_values[s]))
            if watch_idx is not None:
                watch.append(u[..., watch_idx])
            if record_fields:
                fields.append(u)
        ys = {"times": ts, "final_u": u}
        if watch_idx is not None:
            ys["watch"] = torch.stack(watch, dim=-2)
        if record_fields:
            ys["field"] = torch.stack(fields, dim=-2)
        return ys

    simulate.watcher_names = names
    return simulate
