"""Closed-form P1 (linear triangle / interval) element integrals.

The cylindrical weight r is itself linear over each triangle, so every
integral the framework needs has an exact closed form — no quadrature, no
form compiler. This replaces the reference's UFL/FFCx-generated C kernels for
the forms in run_no_diamond.py:278-287 (transient, r-weighted),
space_and_forms.py:143-144 (steady, unweighted) and the gradient projection
in run_no_diamond.py:479-491.

Exact formulas used (A = triangle area, barycentric shape functions φ):
  ∫_T φ_a^α φ_b^β φ_c^γ dA = 2A α!β!γ! / (α+β+γ+2)!
giving ∫φaφb = A/6 (a=b), A/12 (a≠b) and
  ∫φaφbφc = A/10 (a=b=c), A/30 (two equal), A/60 (all distinct).

All functions are vectorized over arbitrary leading batch dimensions and
operate in float64 numpy (assembly is setup-time, host-side).
"""

from __future__ import annotations

import numpy as np

# ∫ φa φb φc / A lookup tensor (3,3,3)
_T3 = np.empty((3, 3, 3), dtype=np.float64)
for _a in range(3):
    for _b in range(3):
        for _c in range(3):
            if _a == _b == _c:
                _T3[_a, _b, _c] = 1.0 / 10.0
            elif _a != _b and _b != _c and _a != _c:
                _T3[_a, _b, _c] = 1.0 / 60.0
            else:
                _T3[_a, _b, _c] = 1.0 / 30.0

# ∫ φa φb / A lookup (3,3)
_T2 = np.full((3, 3), 1.0 / 12.0)
np.fill_diagonal(_T2, 1.0 / 6.0)


def tri_area_grads(coords: np.ndarray):
    """Area and shape-function gradients of P1 triangles.

    Parameters
    ----------
    coords : (..., 3, 2) vertex coordinates (z, r).

    Returns
    -------
    area : (...,) positive triangle areas
    grads : (..., 3, 2) constant gradients ∇φ_a
    """
    p0, p1, p2 = coords[..., 0, :], coords[..., 1, :], coords[..., 2, :]
    d1 = p1 - p0
    d2 = p2 - p0
    det = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]  # 2 * signed area
    area = 0.5 * np.abs(det)
    inv = 1.0 / det
    # ∇φ_a = rot90(p_{a+2} - p_{a+1}) / det   (standard P1 gradient formula)
    x = coords[..., 0]
    y = coords[..., 1]
    gx = np.stack([y[..., 1] - y[..., 2],
                   y[..., 2] - y[..., 0],
                   y[..., 0] - y[..., 1]], axis=-1) * inv[..., None]
    gy = np.stack([x[..., 2] - x[..., 1],
                   x[..., 0] - x[..., 2],
                   x[..., 1] - x[..., 0]], axis=-1) * inv[..., None]
    grads = np.stack([gx, gy], axis=-1)  # (..., 3, 2)
    return area, grads


def tri_stiffness_rw(coords: np.ndarray) -> np.ndarray:
    """r-weighted stiffness: K_ab = ∫ ∇φa·∇φb r dA  (unit conductivity).

    Exact because gradients are constant: K_ab = (∇φa·∇φb) · A · r̄.
    """
    area, grads = tri_area_grads(coords)
    rbar = coords[..., :, 1].mean(axis=-1)
    gg = np.einsum("...ad,...bd->...ab", grads, grads)
    return gg * (area * rbar)[..., None, None]


def tri_mass_rw(coords: np.ndarray) -> np.ndarray:
    """r-weighted mass: M_ab = ∫ φa φb r dA  (unit density)."""
    area, _ = tri_area_grads(coords)
    rv = coords[..., :, 1]  # (..., 3) vertex radii
    return np.einsum("...c,abc->...ab", rv, _T3) * area[..., None, None]


def tri_stiffness(coords: np.ndarray) -> np.ndarray:
    """Unweighted stiffness (steady-state form, ref space_and_forms.py:143)."""
    area, grads = tri_area_grads(coords)
    gg = np.einsum("...ad,...bd->...ab", grads, grads)
    return gg * area[..., None, None]


def tri_mass(coords: np.ndarray) -> np.ndarray:
    """Unweighted mass matrix."""
    area, _ = tri_area_grads(coords)
    return _T2 * area[..., None, None]


def tri_load_rw(coords: np.ndarray) -> np.ndarray:
    """w_a = ∫ φ_a r dA = A (r_a + Σ_c r_c) / 12 — load vector for constant
    sources and test-function weights in the gradient projection rhs."""
    area, _ = tri_area_grads(coords)
    rv = coords[..., :, 1]
    return (rv + rv.sum(axis=-1, keepdims=True)) * area[..., None] / 12.0


def tri_load(coords: np.ndarray) -> np.ndarray:
    """∫ φ_a dA = A/3."""
    area, _ = tri_area_grads(coords)
    return np.broadcast_to((area / 3.0)[..., None],
                           area.shape + (3,)).copy()


def tri_dr_coeff(coords: np.ndarray) -> np.ndarray:
    """Coefficients c_a with (∂u/∂r)|_T = Σ_a c_a u_a (constant per tri)."""
    _, grads = tri_area_grads(coords)
    return grads[..., :, 1]


def tri_dz_coeff(coords: np.ndarray) -> np.ndarray:
    """Coefficients with (∂u/∂z)|_T = Σ_a c_a u_a."""
    _, grads = tri_area_grads(coords)
    return grads[..., :, 0]


# ----------------------------------------------------------------------
# 1D interval elements (for the reduced model, ref run_no_diamond_1d.py:537-546)
# ----------------------------------------------------------------------

def interval_stiffness(h: np.ndarray) -> np.ndarray:
    """K = 1/h [[1,-1],[-1,1]] (unit conductivity), h (...,)."""
    k = 1.0 / np.asarray(h, dtype=np.float64)
    e = np.array([[1.0, -1.0], [-1.0, 1.0]])
    return k[..., None, None] * e


def interval_mass(h: np.ndarray) -> np.ndarray:
    """M = h/6 [[2,1],[1,2]] (unit density)."""
    h = np.asarray(h, dtype=np.float64)
    e = np.array([[2.0, 1.0], [1.0, 2.0]]) / 6.0
    return h[..., None, None] * e


def interval_load(h: np.ndarray) -> np.ndarray:
    """∫ φ_a dz = h/2 per vertex."""
    h = np.asarray(h, dtype=np.float64)
    return np.broadcast_to((h / 2.0)[..., None], h.shape + (2,)).copy()
