"""ELL-format sparse operators for unstructured P1 triangle meshes.

The stencil path covers meshes of the structured generator; this path covers
*imported* meshes (gmsh ``.msh`` files of the reference toolchain, ref
run_no_diamond.py:190-195), so reference meshes run unmodified.

ELL layout: every row stores its ≤K nonzero (column, value) pairs padded to
K (a padded slot points at the row's own column with value 0); the product
is a gather, a multiply and a row sum over the K slots in a fixed order —
never ``index_add_`` or ``scatter_add_``, whose order the device picks.
Per-material value arrays keep the sweep's linear combination of operators
available on the device. Assembly is host-side numpy.

The kernel path (``cuda_cg.cg_tol`` and the transient's step kernels with
ELL column ids) takes the rows in a locality order, reverse Cuthill–McKee
(:func:`locality_order`): a gmsh mesh numbers its nodes as its generator
meets them, and a row's columns then lie far apart in memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from heatflow_tpu_torch.ops import p1
from heatflow_tpu_torch.ops.stencil import apply_stencil, material_combine


@dataclass
class EllOps:
    """Assembled ELL operators for an unstructured triangle mesh."""

    cols: np.ndarray          # (N, K) int32 column ids (self-padded)
    K_vals: np.ndarray        # (n_mats, N, K) stiffness values (unit κ)
    M_vals: np.ndarray        # (n_mats, N, K) r-weighted mass (unit ρc)
    G_vals: np.ndarray        # (N, K) radial-gradient rhs operator
    Mp_vals: np.ndarray       # (N, K) r-weighted mass (projection matrix)
    Kf_vals: np.ndarray | None = None  # (n_mats, N, K) unweighted stiffness
    Mf_vals: np.ndarray | None = None  # (n_mats, N, K) unweighted mass

    def to(self, device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
        """The step loop's operator tensors on ``device``: values in
        ``dtype``, columns as int64, ``own`` the diagonal-slot mask."""
        n = self.cols.shape[0]
        own = self.cols == np.arange(n, dtype=self.cols.dtype)[:, None]
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                      device=device)
        return {"cols": torch.as_tensor(self.cols, dtype=torch.int64,
                                        device=device),
                "own": f(own), "K": f(self.K_vals), "M": f(self.M_vals),
                "G": f(self.G_vals), "Mp": f(self.Mp_vals)}

    def permuted(self, perm: np.ndarray) -> "EllOps":
        """The operators with the nodes in the order ``perm`` (new row k is
        old row perm[k]) and the column ids renumbered to match. Each row
        keeps its slots in their order, so a row's product sums the same
        terms in the same order: the product in the new order is the old
        one's, permuted, bit for bit."""
        perm = np.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=perm.dtype)
        row = lambda a: None if a is None else np.ascontiguousarray(
            a[..., perm, :])
        return EllOps(cols=inv[self.cols[perm]].astype(self.cols.dtype),
                      K_vals=row(self.K_vals), M_vals=row(self.M_vals),
                      G_vals=row(self.G_vals), Mp_vals=row(self.Mp_vals),
                      Kf_vals=row(self.Kf_vals), Mf_vals=row(self.Mf_vals))


def locality_order(cols: np.ndarray) -> np.ndarray:
    """The reverse Cuthill–McKee order of the ELL operator's graph (new row
    k is node ``order[k]``): neighbouring nodes get nearby rows, so a row's
    gathers fall on few cache lines."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    n, k = cols.shape
    graph = csr_matrix((np.ones(n * k, np.int8), cols.ravel(),
                        np.arange(0, n * k + 1, k)), shape=(n, n))
    return np.asarray(reverse_cuthill_mckee(graph, symmetric_mode=True),
                      dtype=np.int64)


def _ell_structure(n, rows, cols):
    """Shared ELL structure for COO triplets: (cols_ell (n, Kmax), inv
    (nnz_raw,) entry→unique-slot map, u_rows, slot, n_unique). Value arrays
    are then reduced with np.bincount(inv, weights=...)."""
    key = rows.astype(np.int64) * n + cols
    uniq, inv = np.unique(key, return_inverse=True)
    u_rows = (uniq // n).astype(np.int64)
    u_cols = (uniq % n).astype(np.int32)
    counts = np.bincount(u_rows, minlength=n)
    Kmax = int(counts.max())
    start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    slot = np.arange(len(uniq)) - start[u_rows]
    cols_ell = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, Kmax))
    cols_ell[u_rows, slot] = u_cols
    return cols_ell, inv, u_rows, slot, len(uniq)


def _coo_to_ell(n, rows, cols, vals_list):
    """Convert shared-sparsity COO triplets (several value arrays) to ELL."""
    cols_ell, inv, u_rows, slot, nuniq = _ell_structure(n, rows, cols)
    out_vals = []
    for v in vals_list:
        s = np.bincount(inv, weights=v, minlength=nuniq)
        o = np.zeros((n, cols_ell.shape[1]), dtype=v.dtype)
        o[u_rows, slot] = s
        out_vals.append(o)
    return cols_ell, out_vals


def assemble_ell(nodes: np.ndarray, tris: np.ndarray, tri_tags: np.ndarray,
                 n_mats: int) -> EllOps:
    """Assemble per-material K/M plus G_r and M_proj in one shared-sparsity
    ELL structure (exact closed-form P1 integrals, ops/p1.py). Each
    material's reductions run over its own triangles only."""
    coords = nodes[tris]                          # (M, 3, 2)
    Ke = p1.tri_stiffness_rw(coords)
    Me = p1.tri_mass_rw(coords)
    Kfe = p1.tri_stiffness(coords)
    Mfe = p1.tri_mass(coords)
    w = p1.tri_load_rw(coords)
    cr = p1.tri_dr_coeff(coords)
    Ge = w[:, :, None] * cr[:, None, :]

    rows = np.repeat(tris, 3, axis=1).ravel()
    cols = np.tile(tris, (1, 3)).ravel()
    n = len(nodes)
    cols_ell, inv, u_rows, slot, nuniq = _ell_structure(n, rows, cols)
    Kmax = cols_ell.shape[1]

    def reduce_subset(elem, tri_idx):
        """Sum elem entries of the given triangles into an (n, Kmax) array."""
        ent = (tri_idx[:, None] * 9 + np.arange(9)).ravel()
        s = np.bincount(inv[ent], weights=elem[tri_idx].reshape(-1),
                        minlength=nuniq)
        o = np.zeros((n, Kmax))
        o[u_rows, slot] = s
        return o

    by_tag = [np.where(tri_tags == m + 1)[0] for m in range(n_mats)]
    K_vals = np.stack([reduce_subset(Ke, t) for t in by_tag])
    M_vals = np.stack([reduce_subset(Me, t) for t in by_tag])
    Kf_vals = np.stack([reduce_subset(Kfe, t) for t in by_tag])
    Mf_vals = np.stack([reduce_subset(Mfe, t) for t in by_tag])
    G_vals = reduce_subset(Ge, np.arange(len(tris)))
    return EllOps(cols=cols_ell, K_vals=K_vals, M_vals=M_vals, G_vals=G_vals,
                  Mp_vals=M_vals.sum(axis=0), Kf_vals=Kf_vals,
                  Mf_vals=Mf_vals)


def ell_apply(cols: torch.Tensor, vals: torch.Tensor, u: torch.Tensor
              ) -> torch.Tensor:
    """SpMV (A @ u) with A in ELL form: u (..., N) → (..., N); ``vals``
    (..., N, K) broadcasts against u's leading dims. The K products of a
    row are summed slot by slot, left to right: a row's sum does not depend
    on the batch or the device. Padded slots carry 0."""
    prod = vals * u[..., cols]
    out = prod[..., 0]
    for k in range(1, prod.shape[-1]):
        out = out + prod[..., k]
    return out


def ell_apply_rows(cols: torch.Tensor, vals: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """:func:`ell_apply` on (..., 1, N) fields: a mesh's nodes as the one
    row of a lattice, the layout of the transient's core planes."""
    return ell_apply(cols, vals, v[..., 0, :])[..., None, :]


def operator_product(cols: torch.Tensor | None):
    """``apply(C, v)`` of an operator format: the stencil's
    (``apply_stencil``), or with ELL column ids ``cols`` the gather on
    (..., 1, N) fields."""
    if cols is None:
        return apply_stencil
    return lambda C, v: ell_apply_rows(cols, C, v)


def ell_combine(K_vals, M_vals, kappas, rho_cvs, dt):
    """(A_vals, M_vals_op) of a backward-Euler step: an unrolled
    multiply-add over the materials, never a matrix product (see
    ``stencil.material_combine``)."""
    M_op = material_combine(rho_cvs, M_vals)
    A = M_op + dt * material_combine(kappas, K_vals)
    return A, M_op


def ell_diag(cols: np.ndarray | torch.Tensor, vals: torch.Tensor
             ) -> torch.Tensor:
    """The diagonal of an ELL operator (..., N)."""
    cols = torch.as_tensor(cols, device=vals.device)
    n = cols.shape[0]
    own = cols == torch.arange(n, dtype=cols.dtype,
                               device=cols.device)[:, None]
    return (vals * own.to(vals.dtype)).sum(-1)
