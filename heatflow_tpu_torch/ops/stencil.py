"""7-point stencil assembly (numpy, host) and application (torch, device).

On a tensor-product triangulated grid every P1 operator has a fixed 7-point
sparsity, so ``A @ u`` is seven shifted elementwise multiply-adds over
(Nz, Nr) tensors. Stencils are assembled *per material* with unit
coefficients, so the operator for any (κ_m, ρc_m, dt) combination is a small
linear combination computed on the device (:func:`combine_operator`).

Every combine and apply here is a chain of plain elementwise multiply-adds on
shifted tensors — never ``einsum``, ``matmul`` or ``conv2d``: a float32
``conv2d`` runs in TF32 under PyTorch's default cuDNN settings, and a
reduced-precision product makes the backward-Euler operator indefinite (see
:func:`material_combine`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from heatflow_tpu_torch.mesh.structured import StructuredMesh
from heatflow_tpu_torch.ops import p1

# Offsets (di, dj): result[i,j] couples to u[i+di, j+dj].
OFFSETS: tuple[tuple[int, int], ...] = (
    (0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1),
)
# Galerkin-coarsened (RAP) operators fill the full 3x3 neighborhood: the
# bilinear-transfer triple product adds the two anti-diagonal couplings.
OFFSETS9: tuple[tuple[int, int], ...] = OFFSETS + ((1, -1), (-1, 1))
_OFF_INDEX = {off: k for k, off in enumerate(OFFSETS)}


def offsets_for(n_points: int) -> tuple[tuple[int, int], ...]:
    if n_points == 7:
        return OFFSETS
    if n_points == 9:
        return OFFSETS9
    raise ValueError(f"unsupported stencil size {n_points} (7 or 9)")


# Grid positions of the three vertices of each triangle type within its quad.
_TRI_VPOS = {
    "lower": ((0, 0), (1, 0), (1, 1)),
    "upper": ((0, 0), (1, 1), (0, 1)),
}


def _tri_coords(mesh: StructuredMesh, kind: str) -> np.ndarray:
    """(Nz-1, Nr-1, 3, 2) vertex coordinates for all triangles of one type."""
    z, r = mesh.z, mesh.r
    nzc, nrc = len(z) - 1, len(r) - 1
    out = np.empty((nzc, nrc, 3, 2), dtype=np.float64)
    for a, (di, dj) in enumerate(_TRI_VPOS[kind]):
        out[:, :, a, 0] = z[di:di + nzc, None]
        out[:, :, a, 1] = r[None, dj:dj + nrc]
    return out


def _scatter_matrix(C: np.ndarray, E: np.ndarray, kind: str) -> None:
    """Accumulate element matrices E (Nz-1, Nr-1, 3, 3) into stencil C (7, Nz, Nr).

    Targets are unique per (a, b) pair across cells, so plain slice adds work.
    """
    nzc, nrc = E.shape[:2]
    vpos = _TRI_VPOS[kind]
    for a in range(3):
        pa = vpos[a]
        for b in range(3):
            pb = vpos[b]
            k = _OFF_INDEX[(pb[0] - pa[0], pb[1] - pa[1])]
            C[k, pa[0]:pa[0] + nzc, pa[1]:pa[1] + nrc] += E[:, :, a, b]


def _scatter_vector_weighted(C: np.ndarray, w: np.ndarray, c: np.ndarray,
                             kind: str) -> None:
    """Accumulate rank-one per-triangle operators w_a c_b into stencil C
    (the gradient-projection rhs operator: b_a += w_a Σ_b c_b u_b)."""
    _scatter_matrix(C, w[..., :, None] * c[..., None, :], kind)


@dataclass
class StencilPack:
    """Assembled geometric stencils for a structured mesh (numpy float64).

    Attributes
    ----------
    K : (n_mats, 7, Nz, Nr)  r-weighted stiffness per material, unit κ
    M : (n_mats, 7, Nz, Nr)  r-weighted mass per material, unit ρc
    K_flat / M_flat : (n_mats, 7, Nz, Nr) unweighted variants
    G_r : (7, Nz, Nr) radial-gradient projection rhs: b = G_r @ u gives
        b_a = ∫ (∂u/∂r) φ_a r dA
    G_z : (7, Nz, Nr) same for ∂u/∂z
    M_proj : (7, Nz, Nr) r-weighted mass summed over materials
    """

    K: np.ndarray
    M: np.ndarray
    K_flat: np.ndarray
    M_flat: np.ndarray
    G_r: np.ndarray
    G_z: np.ndarray
    M_proj: np.ndarray

    def to_device(self, dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
        """The hot-loop planes as ``dtype`` tensors on ``device``."""
        return {name: torch.as_tensor(getattr(self, name), dtype=dtype,
                                      device=device)
                for name in ("K", "M", "G_r", "G_z", "M_proj")}


def assemble_stencils(mesh: StructuredMesh) -> StencilPack:
    """Assemble all geometric stencils for ``mesh`` (host-side, exact P1)."""
    nz, nr = mesh.shape
    n_mats = len(mesh.material_tags)
    shape = (7, nz, nr)

    K = np.zeros((n_mats,) + shape)
    M = np.zeros((n_mats,) + shape)
    K_flat = np.zeros((n_mats,) + shape)
    M_flat = np.zeros((n_mats,) + shape)
    G_r = np.zeros(shape)
    G_z = np.zeros(shape)

    for kind in ("lower", "upper"):
        coords = _tri_coords(mesh, kind)
        Ke = p1.tri_stiffness_rw(coords)
        Me = p1.tri_mass_rw(coords)
        Kfe = p1.tri_stiffness(coords)
        Mfe = p1.tri_mass(coords)
        w = p1.tri_load_rw(coords)
        cr = p1.tri_dr_coeff(coords)
        cz = p1.tri_dz_coeff(coords)

        for m, tag in enumerate(sorted(mesh.material_tags.values())):
            sel = (mesh.cell_tags == tag)[..., None, None]
            _scatter_matrix(K[m], Ke * sel, kind)
            _scatter_matrix(M[m], Me * sel, kind)
            _scatter_matrix(K_flat[m], Kfe * sel, kind)
            _scatter_matrix(M_flat[m], Mfe * sel, kind)
        _scatter_vector_weighted(G_r, w, cr, kind)
        _scatter_vector_weighted(G_z, w, cz, kind)

    return StencilPack(K=K, M=M, K_flat=K_flat, M_flat=M_flat,
                       G_r=G_r, G_z=G_z, M_proj=M.sum(axis=0))


# ----------------------------------------------------------------------
# Device-side operations
# ----------------------------------------------------------------------

def shifted(u: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """out[..., i, ...] = u[..., i+d, ...] along ``dim``, zeros shifted in
    (``u`` itself for d = 0: nothing here writes into its inputs)."""
    if d == 0:
        return u
    n = u.shape[dim]
    out = torch.zeros_like(u)
    if abs(d) < n:
        src, dst = (d, 0) if d > 0 else (0, -d)
        out.narrow(dim, dst, n - abs(d)).copy_(u.narrow(dim, src,
                                                        n - abs(d)))
    return out


def _shifted2(u: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """result[i, j] = u[i+di, j+dj], zero outside the grid."""
    return shifted(shifted(u, di, -2), dj, -1)


def apply_stencil(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A @ u for a 7-point (or 9-point) stencil C (..., 7|9, Nz, Nr)."""
    offs = offsets_for(C.shape[-3])
    out = C[..., 0, :, :] * u
    for k, (di, dj) in enumerate(offs[1:], start=1):
        out = out + C[..., k, :, :] * _shifted2(u, di, dj)
    return out


def apply_combined(A0: torch.Tensor, Kv: torch.Tensor | None,
                   dks: torch.Tensor | None, v: torch.Tensor) -> torch.Tensor:
    """(A0 + dk_b·Kv) v_b for every lane b of v (B, Nz, Nr), dks (B,): the
    operator combined plane by plane as it is applied, as the sweep kernels
    combine it (never a (B, 7|9, Nz, Nr) operator). ``Kv=None``: A0 v_b."""
    if Kv is None:
        return apply_stencil(A0, v)
    dk = dks.reshape(-1, 1, 1)
    out = (A0[0] + dk * Kv[0]) * v
    for k, (di, dj) in enumerate(offsets_for(A0.shape[0])[1:], start=1):
        out = out + (A0[k] + dk * Kv[k]) * _shifted2(v, di, dj)
    return out


def stencil_transpose_apply(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A^T @ u for a stencil A."""
    offs = offsets_for(C.shape[-3])
    out = C[..., 0, :, :] * u
    for k, (di, dj) in enumerate(offs[1:], start=1):
        out = out + _shifted2(C[..., k, :, :] * u, -di, -dj)
    return out


def material_combine(coeffs: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Σ_m coeffs[..., m] · S[m], unrolled — never a matrix product.

    The contraction is tiny (n_mats ≤ ~9) but its output is the
    backward-Euler operator, whose symmetrically scaled condition number is
    ~1e6: a reduced-precision product (bf16 or TF32 inputs) perturbs the
    coefficients enough to push the smallest eigenvalues negative, and CG
    then diverges. An unrolled multiply-add chain is exact in the working
    precision.
    """
    extra = S.ndim - 1

    def c(i):
        v = coeffs[..., i]
        return v.reshape(v.shape + (1,) * extra)

    out = c(0) * S[0]
    for i in range(1, S.shape[0]):
        out = out + c(i) * S[i]
    return out


def combine_operator(K: torch.Tensor, M: torch.Tensor, kappas: torch.Tensor,
                     rho_cvs: torch.Tensor, dt
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, M_op) stencils of a backward-Euler step:

        A = Σ_m ρc_m M_m + dt Σ_m κ_m K_m,    M_op = Σ_m ρc_m M_m
    """
    M_op = material_combine(rho_cvs, M)
    A = M_op + dt * material_combine(kappas, K)
    return A, M_op


def stencil_to_coo(C: np.ndarray):
    """Expand a (7|9, Nz, Nr) stencil into COO triplets (rows, cols, vals)
    over flattened node ids (host, numpy)."""
    C = np.asarray(C)
    npts, nz, nr = C.shape
    rows, cols, vals = [], [], []
    ii, jj = np.meshgrid(np.arange(nz), np.arange(nr), indexing="ij")
    for k, (di, dj) in enumerate(offsets_for(npts)):
        it, jt = ii + di, jj + dj
        ok = (it >= 0) & (it < nz) & (jt >= 0) & (jt < nr)
        rows.append((ii * nr + jj)[ok])
        cols.append((it * nr + jt)[ok])
        vals.append(C[k][ok])
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals))


def sparse_to_stencil(A, shape: tuple[int, int], n_points: int = 9
                      ) -> np.ndarray:
    """scipy sparse (N, N) on the z-major flattened grid → (n_points, Nz, Nr)
    stencil. Raises if any non-negligible entry falls outside the offset
    pattern (a bilinear RAP product is provably 9-point; this guards it)."""
    nz, nr = shape
    A = A.tocoo()
    offs = offsets_for(n_points)
    ri, rj = A.row // nr, A.row % nr
    di = (A.col // nr) - ri
    dj = (A.col % nr) - rj
    ks = np.full(len(A.data), -1, dtype=np.int64)
    for k, (a, b) in enumerate(offs):
        ks[(di == a) & (dj == b)] = k
    outside = ks < 0
    if outside.any():
        scale = np.abs(A.data).max() or 1.0
        bad = np.abs(A.data[outside]).max()
        if bad > 1e-12 * scale:
            raise ValueError(
                f"{int(outside.sum())} entries outside the {n_points}-point "
                f"pattern (max |v| {bad:.3e})")
    C = np.zeros((n_points, nz, nr))
    sel = ~outside
    np.add.at(C, (ks[sel], ri[sel], rj[sel]), A.data[sel])
    return C
