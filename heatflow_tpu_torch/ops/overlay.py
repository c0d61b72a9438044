"""Grid-overlay operators: unstructured geometry as permuted 9-point stencils.

When a mesh's *topology* embeds in a 2D lattice (node positions jittered,
diagonals mixed per quad, grading arbitrary: only the neighbour graph
matters), the exactly assembled unstructured operator is a permuted 9-point
stencil. This module converts assembled :class:`EllOps` to that form, in
the plane order of ``stencil.offsets_for(9)`` (planes 7 and 8 the
anti-diagonals), so the unstructured path runs through the stencil applies
and the CUDA kernels K1-K3. Meshes from ``mesh/unstructured_gen`` carry the
overlay; imported meshes can carry it as a ``mesh_overlay.npz`` sidecar.
Host-side numpy.
"""

from __future__ import annotations

import numpy as np

from heatflow_tpu_torch.ops.ell import EllOps
from heatflow_tpu_torch.ops.stencil import offsets_for


def validate_overlay(n_nodes: int, overlay: dict) -> tuple[np.ndarray, tuple]:
    """Return (index (N,), shape) after checking the lattice is complete."""
    idx = np.asarray(overlay["index"], dtype=np.int64)
    shape = tuple(int(s) for s in overlay["shape"])
    if len(idx) != n_nodes or shape[0] * shape[1] != n_nodes:
        raise ValueError(f"overlay does not cover the mesh: {len(idx)} ids, "
                         f"lattice {shape}, {n_nodes} nodes")
    if len(np.unique(idx)) != n_nodes:
        raise ValueError("overlay index is not a bijection")
    return idx, shape


def _stencil_slots(cols: np.ndarray, idx: np.ndarray, shape: tuple
                   ) -> np.ndarray:
    """(N, K) flat position in the (9, Nz, Nr) stencil of each ELL slot, -1
    for a slot outside the 9-point pattern."""
    nz, nr = shape
    ri, rj = idx // nr, idx % nr                   # (N,) row lattice coords
    di = idx[cols] // nr - ri[:, None]
    dj = idx[cols] % nr - rj[:, None]
    ks = np.full(cols.shape, -1, dtype=np.int64)
    for k, (a, b) in enumerate(offsets_for(9)):
        ks[(di == a) & (dj == b)] = k
    pos = (ks * nz + ri[:, None]) * nr + rj[:, None]
    return np.where(ks >= 0, pos, -1)


def _vals_to_stencil(slots: np.ndarray, vals: np.ndarray, shape: tuple
                     ) -> np.ndarray:
    """(N, K) ELL values → (9, Nz, Nr) stencil over the lattice, each slot
    added into its position in slot order from 0 (np.bincount: the sums of
    the JAX package's np.add.at, bitwise). Raises if a nonzero entry falls
    outside the 9-point pattern (the overlay is inconsistent with the mesh
    connectivity)."""
    bad = (slots < 0) & (vals != 0.0)
    if bad.any():
        raise ValueError(
            f"{int(bad.sum())} operator entries outside the 9-point lattice "
            "pattern — mesh topology does not match the overlay")
    ok = slots >= 0
    C = np.bincount(slots[ok], weights=vals[ok],
                    minlength=9 * shape[0] * shape[1])
    return C.reshape((9,) + tuple(shape))


def ell_to_stencils(ell: EllOps, overlay: dict) -> dict[str, np.ndarray]:
    """Convert the full assembled operator set to lattice 9-point stencils:
    {'K': (m,9,Nz,Nr), 'M': ..., 'Kf', 'Mf', 'G', 'Mp'}."""
    idx, shape = validate_overlay(ell.cols.shape[0], overlay)
    slots = _stencil_slots(ell.cols, idx, shape)
    out = {}
    for name, v in (("K", ell.K_vals), ("M", ell.M_vals),
                    ("Kf", ell.Kf_vals), ("Mf", ell.Mf_vals)):
        if v is None:
            continue
        out[name] = np.stack([_vals_to_stencil(slots, v[m], shape)
                              for m in range(v.shape[0])])
    out["G"] = _vals_to_stencil(slots, ell.G_vals, shape)
    out["Mp"] = _vals_to_stencil(slots, ell.Mp_vals, shape)
    return out


def node_to_lattice(vec: np.ndarray, idx: np.ndarray, shape: tuple
                    ) -> np.ndarray:
    """Scatter a node-ordered vector onto the lattice (host-side setup)."""
    out = np.empty(shape[0] * shape[1], dtype=np.asarray(vec).dtype)
    out[idx] = np.asarray(vec)
    return out.reshape(shape)
