"""The plain reference: the axisymmetric backward-Euler transient of a
configuration in float64, with scipy's sparse LU.

Independent of the program: the operators are assembled here by
quadrature over the mesh's triangles (the degree-3 rule of
``tests/reference_fem.py``, exact for these integrands), from the layout
and the mesh of the frozen copies beside this file. The mesh is the one
the configuration file names (its ``mesh`` kind, ``MESHES``): the
graded grid, two triangles a cell, or the graded non-grid triangulation
of ``triangulation.py`` in its permuted numbering; the node rules below
are the same for both. The boundary terms, the watchers and the
radial-gradient rows follow the upstream project's semantics
(``run_no_diamond.py``): fixed edges at the initial temperature, a
Gaussian heating line driven by the heating curve, the nearest node to
each watcher point, the axis nodes sorted by z, and the r-weighted
projection of du/dr averaged over z bins of the band 0 < r <= 0.25 um.

Each step factors nothing: the LU of the free block is made once a
coefficient set, then every step is two triangular solves.

Beside the exact transient: ``step_residuals`` holds given fields to one
step's system in the norm by which the sweep recipe stops, and
``run_rule`` runs the transient with each step stopped by that rule (the
state-only control rounds its state).
"""

from __future__ import annotations

import csv
import math

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from hfbench.reference.geometry import (build_layout, coupler_watcher_points,
                                        heating_line)
from hfbench.reference.structured import build_structured_mesh
from hfbench.reference.triangulation import build_triangulation

# symmetric degree-3 rule (4 points) in barycentric coordinates
_QP = np.array([[1 / 3, 1 / 3, 1 / 3], [0.6, 0.2, 0.2], [0.2, 0.6, 0.2],
                [0.2, 0.2, 0.6]])
_QW = np.array([-27 / 48, 25 / 48, 25 / 48, 25 / 48])
BAND_RMAX = 0.25e-6      # radial band of the gradient rows (upstream :409)
BIN_DZ = 0.2e-6          # z bin width of the band rows (upstream :494-499)
EDGE_WIDTH = 1e-10       # a boundary row's geometric tolerance (upstream bc.py)
AXIS_TOL = 1e-12         # the axis rows' |r| (upstream :457-465)


def read_heating(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(time, temp) of a heating CSV, rows sorted by time."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    t = np.array([float(r["time"]) for r in rows])
    T = np.array([float(r["temp"]) for r in rows])
    order = np.argsort(t, kind="stable")
    return t[order], T[order]


def bf16_round(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (to nearest, ties to even), back as float64."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def _triangles(nz: int, nr: int) -> np.ndarray:
    """The grid's triangles, two to a cell, split along (i, j)-(i+1, j+1)."""
    i, j = np.meshgrid(np.arange(nz - 1), np.arange(nr - 1), indexing="ij")
    n00, n10 = i * nr + j, (i + 1) * nr + j
    n11, n01 = n10 + 1, n00 + 1
    lower = np.stack([n00, n10, n11], -1).reshape(-1, 3)
    upper = np.stack([n00, n11, n01], -1).reshape(-1, 3)
    return np.concatenate([lower, upper])


def _element_matrices(nodes, tris):
    """Per triangle: r-weighted stiffness (unit conductivity), r-weighted
    mass, and the rank-one projection rhs w_a (d/dr phi_b)."""
    p = nodes[tris]                                     # (T, 3, 2) as (z, r)
    d1, d2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    area = 0.5 * np.abs(det)
    z, r = p[..., 0], p[..., 1]
    gz = np.stack([r[:, 1] - r[:, 2], r[:, 2] - r[:, 0], r[:, 0] - r[:, 1]],
                  1) / det[:, None]
    gr = np.stack([z[:, 2] - z[:, 1], z[:, 0] - z[:, 2], z[:, 1] - z[:, 0]],
                  1) / det[:, None]
    rq = _QP @ r.T                                       # (q, T)
    wr = (_QW[:, None] * rq) * area[None, :]             # (q, T)
    Ke = (gz[:, :, None] * gz[:, None, :] + gr[:, :, None] * gr[:, None, :]) \
        * wr.sum(0)[:, None, None]
    Me = np.einsum("qt,qa,qb->tab", wr, _QP, _QP)
    wa = np.einsum("qt,qa->ta", wr, _QP)
    Ge = wa[:, :, None] * gr[:, None, :]
    return Ke, Me, Ge


def _scatter(E, tris, n, weight=None):
    rows = np.repeat(tris, 3, axis=1).ravel()
    cols = np.tile(tris, (1, 3)).ravel()
    vals = (E if weight is None else E * weight[:, None, None]).ravel()
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


def _close(v, t):
    return np.isclose(v, t, atol=EDGE_WIDTH)


def _grid(domain, mats, size_scale):
    """The structured grid's nodes (z-major), its triangles (two a cell)
    and their tags."""
    mesh = build_structured_mesh(domain, mats, size_scale=size_scale)
    zz, rr = np.meshgrid(mesh.z, mesh.r, indexing="ij")
    return (np.stack([zz.ravel(), rr.ravel()], 1), _triangles(*mesh.shape),
            np.concatenate([mesh.cell_tags.ravel()] * 2))


def _triangulation(domain, mats, size_scale):
    """The graded non-grid triangulation's nodes, triangles and tags, in
    its permuted numbering."""
    tri = build_triangulation(domain, mats, size_scale=size_scale)
    return tri.nodes, tri.cells, tri.cell_tags


# each mesh kind that a configuration file may name (``harness.MESH_KINDS``)
MESHES = {"structured": _grid, "triangulation": _triangulation}


def _node_rules(cfg, mats, nodes):
    """The node rows (Dirichlet, heating line, watchers, axis, band nodes
    and their bins, bin count) of either mesh, by the upstream project's
    rules: each watcher the node nearest by Euclidean distance
    (run_no_diamond.py:385-406), the axis rows the nodes with |r| <=
    AXIS_TOL sorted by z (:457-465), the band rows the nodes with 0 < r <=
    BAND_RMAX in BIN_DZ z-bins (:494-513), the Dirichlet rows the fixed
    edges and the heating line within EDGE_WIDTH. On the grid's z-major
    nodes these are its per-axis rules: the watchers lie on r = 0, and the
    axis rows are its first column."""
    z, r = nodes[:, 0], nodes[:, 1]
    edges = _close(z, z.min()) | _close(z, z.max()) | _close(r, r.max())
    heat_z, length = heating_line(cfg, mats)
    heat = _close(z, heat_z)
    if length is not None:
        heat &= np.abs(r) <= 0.5 * length + 1e-14
    watch = np.array([int(np.argmin(((nodes - p) ** 2).sum(1)))
                      for p in coupler_watcher_points(cfg).values()])
    axis = np.where(np.abs(r) <= AXIS_TOL)[0]
    axis = axis[np.argsort(z[axis], kind="stable")]
    band = np.where((r > 0.0) & (r <= BAND_RMAX))[0]
    edges_z = np.arange(z.min(), z.max() + BIN_DZ, BIN_DZ)
    raw = np.searchsorted(edges_z, z[band]) - 1
    ok = (raw >= 0) & (raw < len(edges_z) - 1)
    used, bins = np.unique(raw[ok], return_inverse=True)
    return edges | heat, heat, watch, axis, band[ok], bins, len(used)


class Reference:
    """The transient of one configuration for any (kappa, fwhm) of the
    varied material: ``run(kappa, fwhm)`` -> dict of ``watch`` (S, W) and,
    with ``record=True``, ``band`` (S, bins) and ``axis`` (S, axis nodes).
    ``mesh`` is the kind of mesh the configuration file names (a key of
    ``MESHES``); fields are in that mesh's node numbering."""

    def __init__(self, cfg: dict, heating_csv: str, *, size_scale=1.0,
                 vary: str = "p_sample", mesh: str = "structured"):
        domain, mats = build_layout(cfg)
        nodes, tris, tags = MESHES[mesh](domain, mats, size_scale)
        n = len(nodes)
        Ke, Me, Ge = _element_matrices(nodes, tris)
        kappa = np.array([m.kappa for m in mats])[tags - 1]
        rho_cv = np.array([m.rho_cv for m in mats])[tags - 1]
        vary_tag = [m.name for m in mats].index(vary) + 1
        on = (tags == vary_tag).astype(float)
        self.K_rest = _scatter(Ke, tris, n, kappa * (1.0 - on))
        self.K_vary = _scatter(Ke, tris, n, on)
        self.M = _scatter(Me, tris, n, rho_cv)
        self.M_proj = _scatter(Me, tris, n)
        self.G_r = _scatter(Ge, tris, n)

        timing = cfg["timing"]
        self.num_steps = int(timing["num_steps"])
        self.dt = float(timing["t_final"]) / self.num_steps
        self.ic = float(cfg["heating"]["ic_temp"])
        self.heat_t, self.heat_T = read_heating(heating_csv)
        self.r_sq = nodes[:, 1] ** 2
        (self.dirichlet, self.heat, self.watch, self.axis_nodes,
         self.band_nodes, self.band_bins, self.n_bins) = _node_rules(
            cfg, mats, nodes)
        self._proj: dict = {}

    def run(self, kappa: float, fwhm: float, *, record: bool = False,
            bf16: bool = False) -> dict:
        """The transient at ``kappa`` for the varied material and laser
        ``fwhm``. ``bf16`` (the control): the operators' entries, the state
        after every step and the rows recorded from it in bfloat16, each
        solve exact."""
        rnd = bf16_round if bf16 else (lambda v: v)
        free, dirich = ~self.dirichlet, self.dirichlet
        A = (self.M + self.dt * (self.K_rest + kappa * self.K_vary)).tocsr()
        M = self.M.copy()
        A.data, M.data = rnd(A.data), rnd(M.data)
        A_ff = A[free][:, free].tocsc()
        A_fd = A[free][:, dirich]
        lu = spla.splu(A_ff)
        profile = np.exp(-4.0 * math.log(2.0) / fwhm ** 2 * self.r_sq) \
            * self.heat
        g0 = self.ic * (dirich - profile)
        offset = self.heat_T[0] - self.ic
        u = np.full(len(free), self.ic)
        out = {"watch": [], "band": [], "axis": []}
        for step in range(self.num_steps):
            t = (step + 1) * self.dt
            amp = np.interp(t, self.heat_t, self.heat_T) - offset
            g = g0 + amp * profile
            rhs = (M @ u)[free] - A_fd @ g[dirich]
            u = g.copy()
            u[free] = lu.solve(rhs)
            u = rnd(u)
            out["watch"].append(u[self.watch])
            if record:
                band, axis = self._rows(u, rnd)
                out["band"].append(rnd(band))
                out["axis"].append(rnd(axis))
        return {k: np.array(v) for k, v in out.items() if v}

    def _system(self, kappa: float, fwhm: float):
        """(free block, free-Dirichlet block, the Dirichlet values' heating
        profile, their value at amplitude 0) of ``kappa`` and ``fwhm``."""
        dirich = self.dirichlet
        free = ~dirich
        A = (self.M + self.dt * (self.K_rest + kappa * self.K_vary)).tocsr()
        profile = np.exp(-4.0 * math.log(2.0) / fwhm ** 2 * self.r_sq) \
            * self.heat
        return (A[free][:, free].tocsr(), A[free][:, dirich], profile,
                self.ic * (dirich - profile))

    def lift(self, step: int, profile, g0):
        """The Dirichlet values of step ``step`` (1-based)."""
        amp = np.interp(step * self.dt, self.heat_t, self.heat_T) \
            - (self.heat_T[0] - self.ic)
        return g0 + amp * profile

    def step_residuals(self, kappa: float, fwhm: float, steps, before,
                       after) -> list[float]:
        """How far the fields ``after[c]`` solve step ``steps[c]``
        (1-based) from ``before[c]``, in float64: ||r|| / ||b|| of the
        Jacobi-scaled free block's system, D^-1/2 (M u_before - A_fd g)
        against D^-1/2 A_ff u_after (g that step's Dirichlet values, D the
        free block's diagonal): the norm by which the sweep recipe stops."""
        A_ff, A_fd, profile, g0 = self._system(kappa, fwhm)
        free = ~self.dirichlet
        s = 1.0 / np.sqrt(A_ff.diagonal())
        out = []
        for step, u0, u1 in zip(steps, before, after):
            g = self.lift(int(step), profile, g0)
            u0 = np.asarray(u0, np.float64).ravel()
            u1 = np.asarray(u1, np.float64).ravel()
            b = (self.M @ u0)[free] - A_fd @ g[self.dirichlet]
            r = s * (b - A_ff @ u1[free])
            out.append(float(np.linalg.norm(r) / np.linalg.norm(s * b)))
        return out

    def run_rule(self, kappa: float, fwhm: float, *, rtol: float,
                 maxiter: int = 4000, state=None, device="cpu") -> dict:
        """The transient at ``kappa`` and ``fwhm`` with each step's system
        solved by the sweep recipe's stopping rule, in float64: conjugate
        gradients on the Jacobi-scaled free block D^-1/2 A D^-1/2 (D its
        diagonal) from the previous state, stopped at the first iteration
        whose ||r|| <= rtol ||b||. ``state`` (the control), when given,
        rounds the state after every step. Returns {"watch": (S, W),
        "states": (S, n), each step's state}; the iterations run in torch
        on ``device``."""
        import torch
        A_ff, A_fd, profile, g0 = self._system(kappa, fwhm)
        free = ~self.dirichlet
        s = 1.0 / np.sqrt(A_ff.diagonal())
        scaled = (sp.diags(s) @ A_ff @ sp.diags(s)).tocsr()
        dev = torch.device(device)
        op = torch.sparse_csr_tensor(
            torch.from_numpy(scaled.indptr.astype(np.int64)),
            torch.from_numpy(scaled.indices.astype(np.int64)),
            torch.from_numpy(scaled.data), size=scaled.shape,
            dtype=torch.float64).to(dev)
        s_t = torch.from_numpy(s).to(dev)
        matvec = lambda v: (op @ v[:, None])[:, 0]
        u = np.full(len(free), self.ic)
        states = []
        for step in range(1, self.num_steps + 1):
            g = self.lift(step, profile, g0)
            b = s_t * torch.from_numpy((self.M @ u)[free]
                                       - A_fd @ g[self.dirichlet]).to(dev)
            y = torch.from_numpy(u[free]).to(dev) / s_t
            r = b - matvec(y)
            p = r.clone()
            rr = float(r @ r)
            stop2 = rtol * rtol * float(b @ b)
            k = 0
            while k < maxiter and rr > stop2:
                Ap = matvec(p)
                pAp = float(p @ Ap)
                alpha = rr / (pAp if pAp != 0.0 else 1.0)
                y += alpha * p
                r -= alpha * Ap
                rr_n = float(r @ r)
                p = r + (rr_n / rr) * p
                rr = rr_n
                k += 1
            u = g.copy()
            u[free] = (s_t * y).cpu().numpy()
            if state is not None:
                u = state(u)
            states.append(u)
        states = np.array(states)
        return {"watch": states[:, self.watch], "states": states}

    def _rows(self, u, rnd):
        """The band-averaged and axis rows of du/dr from the projection
        (its operators' entries through ``rnd``)."""
        key = rnd is bf16_round
        if key not in self._proj:
            Mp, Gr = self.M_proj.copy(), self.G_r.copy()
            Mp.data, Gr.data = rnd(Mp.data), rnd(Gr.data)
            self._proj[key] = (spla.splu(Mp.tocsc()), Gr)
        lu, Gr = self._proj[key]
        gr = lu.solve(Gr @ u)
        sums = np.bincount(self.band_bins, weights=gr[self.band_nodes],
                           minlength=self.n_bins)
        counts = np.bincount(self.band_bins, minlength=self.n_bins)
        return sums / counts, gr[self.axis_nodes]
