"""Problem setup: mesh + materials + BCs + heating → device tensors.

Everything the step loop needs is precomputed here once (stencils, masks,
watcher indices, radial-band bin segments, heating-curve arrays) — the setup
phase of ref run_no_diamond.py:229-513.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from heatflow_tpu_torch.geometry import heating_line
from heatflow_tpu_torch.mesh.structured import StructuredMesh
from heatflow_tpu_torch.ops.stencil import StencilPack, assemble_stencils
from heatflow_tpu_torch.sim.bc import HeatingCurve, structured_row_mask

# Radial-gradient sampling constants (ref run_no_diamond.py:409,494-499)
BAND_RMAX = 0.25e-6     # radial band for z-binned averaging: 0 < r <= 0.25 µm
BIN_DZ = 0.2e-6         # z bin width 0.2 µm

_STENCIL_FIELDS = ("K", "M", "K_flat", "M_flat", "G_r", "G_z", "M_proj")
_RADIAL_FIELDS = ("band_nodes", "band_bin_ids", "bin_counts", "bin_centers",
                  "axis_z")


@dataclass
class RadialSampling:
    """Precomputed segments for the two radial-gradient CSV outputs."""
    band_nodes: np.ndarray      # (nb,) flat node ids with 0 < r <= BAND_RMAX
    band_bin_ids: np.ndarray    # (nb,) bin index per band node
    bin_counts: np.ndarray      # (n_bins,)
    bin_centers: np.ndarray     # (n_bins,) z centers (CSV columns)
    axis_z: np.ndarray          # (Nz,) z coords of r=0 nodes (raw CSV columns)


@dataclass
class Problem2D:
    """A fully prepared axisymmetric transient heat-conduction problem."""

    mesh: StructuredMesh
    stencils: StencilPack                  # host (numpy, float64)
    heating: HeatingCurve
    dt: float
    num_steps: int
    ic_temp: float
    fwhm: float
    kappas: np.ndarray                     # (n_mats,) default material values
    rho_cvs: np.ndarray                    # (n_mats,)

    dirichlet_mask: np.ndarray             # (Nz, Nr) bool, all constrained dofs
    heat_mask: np.ndarray                  # (Nz, Nr) bool, heating line dofs
    r_sq: np.ndarray                       # (Nz, Nr) r² (for the Gaussian)

    watcher_names: list[str] = field(default_factory=list)
    watcher_idx: np.ndarray | None = None  # (W, 2) (i, j) grid indices
    radial: RadialSampling | None = None

    extras: dict[str, Any] = field(default_factory=dict)

    @property
    def free_mask(self) -> np.ndarray:
        return ~self.dirichlet_mask

    def device_arrays(self, dtype: torch.dtype, device
                      ) -> dict[str, torch.Tensor]:
        """All step-loop arrays as tensors on ``device``: floating arrays in
        ``dtype``, index arrays as int64."""
        out = self.stencils.to_device(dtype, device)
        f = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)
        out["dirichlet"] = f(self.dirichlet_mask)
        out["free"] = f(self.free_mask)
        out["heat_profile_base"] = f(self.heat_mask)
        out["r_sq"] = f(self.r_sq)
        out["heat_t"] = f(self.heating.time)
        out["heat_T"] = f(self.heating.temp)
        out["kappas"] = f(self.kappas)
        out["rho_cvs"] = f(self.rho_cvs)
        if self.watcher_idx is not None and len(self.watcher_idx):
            nr = len(self.mesh.r)
            out["watch_flat"] = torch.as_tensor(
                self.watcher_idx[:, 0] * nr + self.watcher_idx[:, 1],
                dtype=torch.int64, device=device)
        if self.radial is not None:
            out["band_nodes"] = torch.as_tensor(
                self.radial.band_nodes, dtype=torch.int64, device=device)
            out["band_bins"] = torch.as_tensor(
                self.radial.band_bin_ids, dtype=torch.int64, device=device)
            out["bin_counts"] = f(self.radial.bin_counts)
            slots, fill = band_slots(self.radial)
            out["band_slots"] = torch.as_tensor(slots, device=device)
            out["band_fill"] = torch.as_tensor(fill, device=device)
        return out

    def to_arrays(self) -> dict[str, np.ndarray]:
        """The problem's numeric state as numpy arrays (the inverse of
        :func:`problem_from_arrays`). Reads attributes only, so it also
        takes any object shaped like a ``Problem2D``."""
        out = {name: getattr(self.stencils, name) for name in _STENCIL_FIELDS}
        out.update(dirichlet_mask=self.dirichlet_mask,
                   heat_mask=self.heat_mask, r_sq=self.r_sq,
                   kappas=self.kappas, rho_cvs=self.rho_cvs,
                   scalars=np.array([self.dt, self.num_steps, self.ic_temp,
                                     self.fwhm], dtype=np.float64))
        if self.watcher_idx is not None:
            out["watcher_idx"] = self.watcher_idx
        if self.radial is not None:
            out.update({name: getattr(self.radial, name)
                        for name in _RADIAL_FIELDS})
        return out

    @classmethod
    def from_reference(cls, obj, mesh: StructuredMesh,
                       heating: HeatingCurve) -> "Problem2D":
        """Build the port's problem from any object with the attributes of a
        ``Problem2D`` (read duck-typed, as numpy), on the port's own
        ``mesh`` and ``heating``."""
        return problem_from_arrays(cls.to_arrays(obj), mesh, heating,
                                   watcher_names=list(obj.watcher_names))


def problem_from_arrays(arrays: dict[str, np.ndarray], mesh: StructuredMesh,
                        heating: HeatingCurve, *,
                        watcher_names: list[str] = ()) -> Problem2D:
    """Assemble a :class:`Problem2D` from the numpy arrays of
    :meth:`Problem2D.to_arrays` (or of the JAX package's problem)."""
    a = {k: np.asarray(v) for k, v in arrays.items()}
    dt, num_steps, ic_temp, fwhm = (float(v) for v in a["scalars"])
    radial = None
    if "band_nodes" in a:
        radial = RadialSampling(**{name: a[name] for name in _RADIAL_FIELDS})
    return Problem2D(
        mesh=mesh,
        stencils=StencilPack(**{name: a[name] for name in _STENCIL_FIELDS}),
        heating=heating, dt=dt, num_steps=int(num_steps), ic_temp=ic_temp,
        fwhm=fwhm, kappas=a["kappas"], rho_cvs=a["rho_cvs"],
        dirichlet_mask=a["dirichlet_mask"].astype(bool),
        heat_mask=a["heat_mask"].astype(bool), r_sq=a["r_sq"],
        watcher_names=list(watcher_names), watcher_idx=a.get("watcher_idx"),
        radial=radial)


def band_slots(radial: RadialSampling) -> tuple[np.ndarray, np.ndarray]:
    """(slots (n_bins, P) int64, fill (n_bins, P) bool): each bin's band
    nodes as flat node ids, padded to a power of two P (fill marks the real
    entries), for :func:`band_average`."""
    bins = np.asarray(radial.band_bin_ids)
    n_bins = len(radial.bin_counts)
    order = np.argsort(bins, kind="stable")
    counts = np.bincount(bins, minlength=n_bins)
    width = 1 << int(max(1, counts.max(initial=1)) - 1).bit_length()
    pos = np.arange(len(bins)) - np.repeat(np.cumsum(counts) - counts,
                                           counts)
    slots = np.zeros((n_bins, width), dtype=np.int64)
    fill = np.zeros((n_bins, width), dtype=bool)
    slots[bins[order], pos] = np.asarray(radial.band_nodes)[order]
    fill[bins[order], pos] = True
    return slots, fill


def band_average(flat: torch.Tensor, slots: torch.Tensor,
                 fill: torch.Tensor, bin_counts: torch.Tensor
                 ) -> torch.Tensor:
    """The band-averaged rows (..., n_bins) of nodal values flat (..., N):
    each bin's band nodes gathered into its padded slots and summed
    pairwise in a fixed order, so a lane's rows depend neither on the batch
    nor on the device's thread order (a CUDA ``index_add_`` adds in
    arbitrary order)."""
    return band_reduce(band_values(flat, slots, fill), bin_counts)


def band_values(flat: torch.Tensor, slots: torch.Tensor, fill: torch.Tensor
                ) -> torch.Tensor:
    """Each bin's band node values in their padded slots (..., n_bins, P),
    zeros in the unfilled ones."""
    return torch.where(fill, flat[..., slots],
                       torch.zeros((), dtype=flat.dtype, device=flat.device))


def band_reduce(v: torch.Tensor, bin_counts: torch.Tensor) -> torch.Tensor:
    """The slots' pairwise sums in a fixed order over the count: the band
    average of :func:`band_values`."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0] / bin_counts


def initial_condition(mesh: StructuredMesh, init) -> np.ndarray:
    """Build a (Nz, Nr) initial temperature field from a scalar, a callable
    f(z, r) (vectorized or scalar), or an array (ref
    space_and_forms.py:231-266)."""
    nz, nr = mesh.shape
    if np.isscalar(init):
        return np.full((nz, nr), float(init))
    if callable(init):
        zz, rr = np.meshgrid(mesh.z, mesh.r, indexing="ij")
        try:
            out = np.asarray(init(zz, rr), dtype=float)
            if out.shape != (nz, nr):
                raise ValueError
            return out
        except Exception:
            out = np.empty((nz, nr))
            for i, z in enumerate(mesh.z):
                for j, r in enumerate(mesh.r):
                    out[i, j] = init(z, r)
            return out
    arr = np.asarray(init, dtype=float)
    if arr.size != nz * nr:
        raise ValueError("array length does not match the number of DOFs")
    return arr.reshape(nz, nr)


def _radial_sampling(mesh: StructuredMesh) -> RadialSampling:
    z, r = mesh.z, mesh.r
    nr = len(r)
    band_j = np.where((r > 0.0) & (r <= BAND_RMAX))[0]
    ii, jj = np.meshgrid(np.arange(len(z)), band_j, indexing="ij")
    band_nodes = (ii * nr + jj).ravel()
    band_z = z[ii.ravel()]

    edges = np.arange(z.min(), z.max() + BIN_DZ, BIN_DZ)
    raw_bin = np.searchsorted(edges, band_z) - 1
    valid = (raw_bin >= 0) & (raw_bin < len(edges) - 1)
    band_nodes = band_nodes[valid]
    raw_bin = raw_bin[valid]

    # keep only non-empty bins, in z order (ref run_no_diamond.py:507-513)
    used = np.unique(raw_bin)
    remap = -np.ones(len(edges) - 1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    bin_ids = remap[raw_bin]
    counts = np.bincount(bin_ids, minlength=len(used)).astype(np.float64)
    centers = 0.5 * (edges[used] + edges[used + 1])
    return RadialSampling(band_nodes=band_nodes, band_bin_ids=bin_ids,
                          bin_counts=counts, bin_centers=centers,
                          axis_z=z.copy())


def radial_band_analysis(mesh: StructuredMesh, band_width: float = 0.1e-6
                         ) -> dict:
    """The reference's β-clustering diagnostic of the radial sampling band
    (ref run_no_diamond.py:409-432): β = mean r of band nodes / band width.
    β≈1 ⇒ nodes clustered at the outer edge; β≈0.5 ⇒ uniform."""
    r = mesh.r
    band_j = np.where((r > 0.0) & (r <= band_width))[0]
    n_nodes = len(band_j) * len(mesh.z)
    if len(band_j) == 0:
        return {"n_band_nodes": 0, "band_width": band_width, "beta": np.nan,
                "verdict": "no nodes in band"}
    mean_r = float(r[band_j].mean())
    beta = mean_r / band_width
    if beta > 0.95:
        verdict = "clustered near the outer edge (β ≈ 1)"
    elif 0.45 < beta < 0.55:
        verdict = "uniformly distributed (β ≈ 0.5)"
    else:
        verdict = "neither fully clustered nor uniform"
    return {"n_band_nodes": n_nodes, "band_width": band_width,
            "mean_r": mean_r, "beta": beta, "verdict": verdict}


def build_problem(mesh: StructuredMesh,
                  heating: HeatingCurve,
                  cfg: dict,
                  *,
                  watcher_points: dict[str, tuple[float, float]] | None = None,
                  stencils: StencilPack | None = None) -> Problem2D:
    """Assemble a Problem2D from a mesh, heating curve and a reference-schema
    config (timing / heating sections + per-material properties)."""
    t_final = float(cfg["timing"]["t_final"])
    num_steps = int(cfg["timing"]["num_steps"])
    dt = t_final / num_steps
    ic_temp = float(cfg["heating"]["ic_temp"])
    fwhm = float(cfg["heating"]["fwhm"])

    mats = mesh.materials
    kappas = np.array([m.kappa for m in mats], dtype=np.float64)
    rho_cvs = np.array([m.rho_cv for m in mats], dtype=np.float64)

    if stencils is None:
        stencils = assemble_stencils(mesh)

    z, r = mesh.z, mesh.r
    # Fixed edges at ic_temp: left, right and top (r = rmax). The r = 0 axis
    # has no BC (natural axisymmetric condition), ref run_no_diamond.py:311-314.
    edge_mask = (structured_row_mask(z, r, "left")
                 | structured_row_mask(z, r, "right")
                 | structured_row_mask(z, r, "top"))

    # Heating line: inner 'x' row at the p-side coupler's left edge, clipped
    # to |r| <= r_sample, ref :315-322; custom layouts override via
    # heating.z / heating.r_max.
    heat_z, heat_length = heating_line(cfg, mats)
    heat_mask = structured_row_mask(
        z, r, "x", coord=heat_z, center=0.0, length=heat_length)

    dirichlet = edge_mask | heat_mask
    rr = np.broadcast_to(r[None, :], (len(z), len(r)))
    r_sq = (rr ** 2).astype(np.float64)

    names: list[str] = []
    widx = None
    if watcher_points:
        names = list(watcher_points.keys())
        widx = np.array(
            [[int(np.argmin(np.abs(z - pz))), int(np.argmin(np.abs(r - pr)))]
             for pz, pr in watcher_points.values()], dtype=np.int64)

    return Problem2D(
        mesh=mesh, stencils=stencils, heating=heating, dt=dt,
        num_steps=num_steps, ic_temp=ic_temp, fwhm=fwhm, kappas=kappas,
        rho_cvs=rho_cvs, dirichlet_mask=dirichlet, heat_mask=heat_mask,
        r_sq=r_sq, watcher_names=names, watcher_idx=widx,
        radial=_radial_sampling(mesh))
