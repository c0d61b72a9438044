"""Geometric multigrid preconditioner for the implicit heat operator.

The DAC meshes combine 5 decades of conductivity contrast with 3 decades of
mesh grading, so Jacobi-PCG needs O(10²-10³) iterations per implicit step.
This V-cycle brings that down to O(10) on small and moderately graded grids
(a third of plain CG's count or less in the tests). On the flagship grid
(251 x 1107) it does not: the first step from a zero seed takes 395
iterations in float64 at rtol 1e-6 wrt ‖b‖, in this package and in
heatflow_tpu alike (tests/test_torch_multigrid.py, the slow test), and
several hundred a step in float32 at rtol 1e-5: its point smoothers do not
see the graded cells' anisotropy, which the line solves of 'rline' do.

Design (plain torch, any device; Python loops over levels):
  * hierarchy: every-other-grid-line coarsening of the graded tensor grid
    (endpoints kept), per level;
  * coarse operators: **Galerkin (RAP)** by default — per-material
    K_c = Pᵀ K_f P, M_c = Pᵀ M_f P computed on the host at setup, so the thin
    high-contrast layers keep their algebraic influence on every level; a
    sweep's per-config operator stays the same cheap linear combination on
    every level because RAP is linear in the material coefficients. RAP of
    the 7-point P1 stencil under bilinear transfers is exactly 9-point, and
    9-point is closed under further RAP. ``coarsening='rediscretize'``
    re-assembles P1 on the coarse grid instead;
  * transfers: tensor-product bilinear interpolation P (coarse nodes are a
    subset of fine nodes), restriction R = Pᵀ. The restriction sums each
    coarse value's contributions in a fixed order (sorted gathers and a
    segmented sum over contiguous runs, never ``index_add_``, whose atomic
    adds land in a different order from run to run on a CUDA device), so a
    V-cycle is bitwise repeatable;
  * smoother: Chebyshev polynomial or weighted Jacobi (ω = 2/3), symmetric
    pre/post counts, masked to free dofs, so the V-cycle is an SPD
    preconditioner for CG;
  * Dirichlet masks restrict exactly (coarse nodes are fine nodes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from heatflow_tpu_torch.mesh.structured import StructuredMesh
from heatflow_tpu_torch.ops.stencil import apply_stencil, assemble_stencils

OMEGA = 2.0 / 3.0


def _coarsen_indices(n: int) -> np.ndarray:
    idx = list(range(0, n, 2))
    if idx[-1] != n - 1:
        idx.append(n - 1)
    return np.asarray(idx, dtype=np.int64)


def _axis_interp(fine: np.ndarray, idx: np.ndarray):
    """(left_index, left_weight) arrays: fine value = w*c[li] + (1-w)*c[li+1]."""
    pos = fine[idx]
    li = np.clip(np.searchsorted(pos, fine, side="right") - 1, 0,
                 len(idx) - 2)
    denom = pos[li + 1] - pos[li]
    w = (pos[li + 1] - fine) / np.where(denom > 0, denom, 1.0)
    return li.astype(np.int64), np.clip(w, 0.0, 1.0)


@dataclass
class MGLevel:
    """Host-side geometry + assembly for one level of the hierarchy."""
    mesh: StructuredMesh
    dirichlet: np.ndarray               # (Nz, Nr) bool
    K: np.ndarray                       # (n_mats, 7|9, Nz, Nr)
    M: np.ndarray
    # transfer data to THIS level from the finer one (None on the finest)
    liz: np.ndarray | None = None
    wz: np.ndarray | None = None
    lir: np.ndarray | None = None
    wr: np.ndarray | None = None


def _axis_transfer_matrix(li: np.ndarray, w: np.ndarray, n_coarse: int):
    """1D interpolation matrix P (n_fine, n_coarse) from (left_index,
    left_weight) arrays; the full transfer is kron(Pz, Pr) (z-major ids)."""
    import scipy.sparse as sp
    nf = len(li)
    rows = np.concatenate([np.arange(nf)] * 2)
    cols = np.concatenate([li, li + 1])
    vals = np.concatenate([w, 1.0 - w])
    return sp.coo_matrix((vals, (rows, cols)), shape=(nf, n_coarse)).tocsr()


def build_hierarchy(mesh: StructuredMesh, dirichlet: np.ndarray,
                    *, min_size: int = 6, max_levels: int = 10,
                    stencils=None, coarsening: str = "rap") -> list[MGLevel]:
    """Build the level list, finest first. ``stencils`` can pass the already-
    assembled finest-level StencilPack to avoid re-assembly.

    coarsening: 'rap' (Galerkin triple product, 9-point coarse stencils) or
    'rediscretize' (re-assembled P1 on the coarse grid, 7-point).
    """
    import scipy.sparse as sp
    from heatflow_tpu_torch.ops.stencil import (sparse_to_stencil,
                                                stencil_to_coo)

    if stencils is None:
        stencils = assemble_stencils(mesh)
    levels = [MGLevel(mesh=mesh, dirichlet=dirichlet.astype(bool),
                      K=stencils.K, M=stencils.M)]
    while len(levels) < max_levels:
        fine = levels[-1]
        nz, nr = fine.mesh.shape
        if min(nz, nr) <= min_size:
            break
        iz = _coarsen_indices(nz)
        ir = _coarsen_indices(nr)
        cmesh = StructuredMesh(
            z=fine.mesh.z[iz], r=fine.mesh.r[ir],
            cell_tags=_coarse_tags(fine.mesh, iz, ir),
            material_tags=dict(fine.mesh.material_tags),
            materials=list(fine.mesh.materials))
        liz, wz = _axis_interp(fine.mesh.z, iz)
        lir, wr = _axis_interp(fine.mesh.r, ir)
        if coarsening == "rap":
            n = fine.mesh.num_nodes
            P = sp.kron(_axis_transfer_matrix(liz, wz, len(iz)),
                        _axis_transfer_matrix(lir, wr, len(ir))).tocsr()

            def rap(C):
                rows, cols, vals = stencil_to_coo(C)
                A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
                return sparse_to_stencil((P.T @ A @ P).tocoo(), cmesh.shape)

            cK = np.stack([rap(fine.K[m]) for m in range(fine.K.shape[0])])
            cM = np.stack([rap(fine.M[m]) for m in range(fine.M.shape[0])])
        elif coarsening == "rediscretize":
            cst = assemble_stencils(cmesh)
            cK, cM = cst.K, cst.M
        else:
            raise ValueError(f"unknown coarsening {coarsening!r}")
        levels.append(MGLevel(
            mesh=cmesh, dirichlet=fine.dirichlet[np.ix_(iz, ir)],
            K=cK, M=cM, liz=liz, wz=wz, lir=lir, wr=wr))
    return levels


def _coarse_tags(fine_mesh: StructuredMesh, iz: np.ndarray, ir: np.ndarray
                 ) -> np.ndarray:
    """Coarse-cell material tags by majority of covered fine cells (keeps
    thin layers influencing the coarse operator where they dominate)."""
    zc = fine_mesh.z[iz]
    rc = fine_mesh.r[ir]
    n_tags = len(fine_mesh.material_tags)
    # fine cell centers → coarse cell bins
    zf = 0.5 * (fine_mesh.z[:-1] + fine_mesh.z[1:])
    rf = 0.5 * (fine_mesh.r[:-1] + fine_mesh.r[1:])
    bz = np.clip(np.searchsorted(zc, zf) - 1, 0, len(zc) - 2)
    br = np.clip(np.searchsorted(rc, rf) - 1, 0, len(rc) - 2)
    counts = np.zeros((len(zc) - 1, len(rc) - 1, n_tags + 1), dtype=np.int64)
    np.add.at(counts, (bz[:, None], br[None, :], fine_mesh.cell_tags), 1)
    return counts[..., 1:].argmax(axis=-1).astype(np.int32) + 1


# ----------------------------------------------------------------------
# Device-side V-cycle
# ----------------------------------------------------------------------

def _prolong(level_dev, xc):
    """Coarse → fine bilinear interpolation (tensor product of 1D interps)."""
    liz, wz, lir, wr = (level_dev["liz"], level_dev["wz"],
                        level_dev["lir"], level_dev["wr"])
    x = (xc.index_select(-2, liz) * wz[:, None]
         + xc.index_select(-2, liz + 1) * (1.0 - wz)[:, None])
    return (x.index_select(-1, lir) * wr
            + x.index_select(-1, lir + 1) * (1.0 - wr))


def _gather_plan(li: np.ndarray, n_coarse: int):
    """The fixed-order plan of one axis of the restriction. The left index
    ``li`` is non-decreasing, so the fine lines that feed coarse line c form
    two contiguous runs: those with li == c (weight w) and those with
    li + 1 == c (weight 1 − w). Returns the run starts and lengths, (2,
    n_coarse) each, and the longest run."""
    li = np.asarray(li)
    if np.any(np.diff(li) < 0):
        raise ValueError("transfer left indices must be non-decreasing")
    c = np.arange(n_coarse)
    lo = np.stack([np.searchsorted(li, c, side="left"),
                   np.searchsorted(li + 1, c, side="left")])
    hi = np.stack([np.searchsorted(li, c, side="right"),
                   np.searchsorted(li + 1, c, side="right")])
    return lo, hi - lo, int((hi - lo).max())


def _restrict_axis(x, w, plan, dim: int):
    """Σ over the fine lines feeding each coarse line along ``dim``, the
    left-index run first and then the right-index run, each in fine-line
    order: gathers and elementwise adds only, so the order of every sum is
    fixed."""
    start, length, longest = plan
    shape = [1] * x.ndim
    shape[dim] = -1
    wl, wr_ = (w.reshape(shape), (1.0 - w).reshape(shape))
    n_f = x.shape[dim]
    out = None
    for run, weighted in ((0, x * wl), (1, x * wr_)):
        for k in range(longest):
            idx = torch.clamp(start[run] + k, max=n_f - 1)
            live = (length[run] > k).to(x.dtype).reshape(shape)
            term = weighted.index_select(dim, idx) * live
            out = term if out is None else out + term
    return out


def _restrict(level_dev, rf, coarse_shape):
    """Fine → coarse: R = Pᵀ, summed in a fixed order (see the module
    docstring); ``coarse_shape`` is implied by the level's plans."""
    x = _restrict_axis(rf, level_dev["wz"], level_dev["plan_z"], -2)
    return _restrict_axis(x, level_dev["wr"], level_dev["plan_r"], -1)


def device_levels(levels: list[MGLevel], dtype=torch.float32,
                  device="cpu"):
    """Per-level host data as tensors of ``dtype`` on ``device`` (operators
    are combined later, per config)."""
    t = lambda v, dt=dtype: torch.as_tensor(np.asarray(v), dtype=dt,
                                            device=device)
    out = []
    for lv in levels:
        d = {
            "K": t(lv.K),
            "M": t(lv.M),
            "free": t(~lv.dirichlet),
            "shape": lv.mesh.shape,
        }
        if lv.liz is not None:
            d["liz"] = t(lv.liz, torch.int64)
            d["wz"] = t(lv.wz)
            d["lir"] = t(lv.lir, torch.int64)
            d["wr"] = t(lv.wr)
            for name, li, n_c in (("plan_z", lv.liz, lv.mesh.shape[0]),
                                  ("plan_r", lv.lir, lv.mesh.shape[1])):
                start, length, longest = _gather_plan(li, n_c)
                d[name] = (t(start, torch.int64), t(length, torch.int64),
                           longest)
        out.append(d)
    return out


def make_vcycle(level_ops, *, nu_pre: int = 2, nu_post: int = 2,
                nu_coarse: int = 24, omega: float = OMEGA,
                smoother: str = "chebyshev", cheb_degree: int = 4,
                cheb_coarse_degree: int = 16):
    """Build the V-cycle preconditioner fn(r) -> z ≈ A⁻¹ r (masked).

    level_ops: list of dicts with 'A' (7/9-point stencil), 'free', 'shape'
    and transfer arrays — i.e. device_levels() entries augmented with the
    combined operator 'A' for the current material parameters.

    smoother: 'chebyshev' (default — a fixed polynomial in D⁻¹A targeting
    [0.08 λmax, 1.05 λmax] with λmax from a Gershgorin bound; far stronger
    than point Jacobi on the graded anisotropic DAC cells and still a fixed
    linear SPD operator, so CG stays valid) or 'jacobi' (ω-damped point
    Jacobi).
    """
    diags, dinvs, lam_maxs = [], [], []
    for lv in level_ops:
        A, free = lv["A"], lv["free"]
        d = A[..., 0, :, :]
        d = torch.where(d != 0, d, torch.ones_like(d))
        diags.append(d)
        dinvs.append(free / d)
        if smoother == "chebyshev":
            # Gershgorin bound on λmax(D⁻¹A) over free dofs
            rowsum = torch.sum(torch.abs(A), dim=-3)
            lam_maxs.append(torch.amax(rowsum / d * free, dim=(-2, -1),
                                       keepdim=True))

    def smooth_jacobi(l, x, b, nu):
        A, free = level_ops[l]["A"], level_ops[l]["free"]
        for _ in range(nu):
            x = x + omega * (b - apply_stencil(A, x)) / diags[l] * free
        return x

    def smooth_cheb(l, x, b, degree):
        """Chebyshev iteration on D⁻¹A; a fixed degree-``degree``
        polynomial, linear in b, identical pre/post → SPD V-cycle."""
        A, free = level_ops[l]["A"], level_ops[l]["free"]
        dinv, lmax = dinvs[l], lam_maxs[l]
        lo, hi = 0.08 * lmax, 1.05 * lmax
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = (b - apply_stencil(A, x)) * free
        d = dinv * r / theta
        x = x + d
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = (b - apply_stencil(A, x)) * free
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * r)
            x = x + d
            rho = rho_new
        return x

    if smoother == "chebyshev":
        smooth = smooth_cheb
        pre_n, post_n, coarse_n = cheb_degree, cheb_degree, cheb_coarse_degree
    elif smoother == "jacobi":
        smooth = smooth_jacobi
        pre_n, post_n, coarse_n = nu_pre, nu_post, nu_coarse
    else:
        raise ValueError(f"unknown smoother {smoother!r}")

    n_levels = len(level_ops)

    def vcycle_at(l, b):
        if l == n_levels - 1:
            return smooth(l, torch.zeros_like(b), b, coarse_n)
        A, free = level_ops[l]["A"], level_ops[l]["free"]
        x = smooth(l, torch.zeros_like(b), b, pre_n)
        res = (b - apply_stencil(A, x)) * free
        nxt = level_ops[l + 1]
        bc = _restrict(nxt, res, nxt["shape"]) * nxt["free"]
        xc = vcycle_at(l + 1, bc)
        x = x + _prolong(nxt, xc) * free
        return smooth(l, x, b, post_n)

    return lambda r: vcycle_at(0, r)
