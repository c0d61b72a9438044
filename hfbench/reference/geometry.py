"""Frozen copy of the material layout of ``heatflow_tpu_torch/geometry.py``
(the stacks, the heating line, the coupler watcher points) for the plain
reference: it imports nothing of the program.

Material layout derivation for DAC sample-stack geometries.

Reproduces the geometry math of the reference drivers:

  * 5-material "no diamond" stack (p_ins / p_coupler / p_sample / o_coupler /
    o_ins stacked along z, all starting at r=0), ref: run_no_diamond.py:62-131.
  * 9-material full-DAC stack adding diamond culets spanning the full radial
    extent, a gasket and a gasket-insulator ring, ref: run_with_diamond.py:58-181.

Coordinates are (z, r): z is the axial direction (laser axis), r >= 0 the
radial direction. All rectangles are [zmin, zmax, rmin, rmax].
"""

from __future__ import annotations

from dataclasses import dataclass



def mat_float(cfg: dict, mat: str, key: str) -> float:
    """``cfg['mats'][mat][key]`` as a float."""
    return float(cfg["mats"][mat][key])

NO_DIAMOND_MATS = ("p_ins", "p_coupler", "p_sample", "o_coupler", "o_ins")
WITH_DIAMOND_MATS = ("p_diam", "p_ins", "p_coupler", "p_sample", "o_coupler",
                     "o_ins", "o_diam", "gasket", "g_ins")


@dataclass(frozen=True)
class MaterialSpec:
    """A rectangular material region with physical properties.

    Equivalent in role to the reference's Material
    (ref: mesh_and_materials/materials.py:16-34).
    """

    name: str
    bounds: tuple[float, float, float, float]  # (zmin, zmax, rmin, rmax)
    rho_cv: float       # volumetric heat capacity rho * cv  [J / m^3 / K]
    kappa: float        # thermal conductivity [W / m / K]
    mesh_size: float    # target element size inside the region [m]

    def __post_init__(self):
        zmin, zmax, rmin, rmax = self.bounds
        if not (zmax > zmin and rmax > rmin):
            raise ValueError(
                f"{self.name}: degenerate rectangle {self.bounds}")
        if self.mesh_size <= 0:
            raise ValueError(f"{self.name}: mesh_size must be positive")

    def contains(self, z: float, r: float) -> bool:
        zmin, zmax, rmin, rmax = self.bounds
        return zmin <= z <= zmax and rmin <= r <= rmax


def _mat_spec(cfg: dict, name: str, bounds) -> MaterialSpec:
    return MaterialSpec(
        name=name,
        bounds=tuple(float(b) for b in bounds),
        rho_cv=mat_float(cfg, name, "rho") * mat_float(cfg, name, "cv"),
        kappa=mat_float(cfg, name, "k"),
        mesh_size=mat_float(cfg, name, "mesh"),
    )


def layout_no_diamond(cfg: dict):
    """Derive the 5-material stack (ref: run_no_diamond.py:62-131).

    Returns (domain_bounds, [MaterialSpec]) with domain_bounds =
    (zmin, zmax, rmin, rmax). Note that, as in the reference, the *meshed*
    region is the union of the material rectangles; the nominal domain rmax
    can exceed it (the reference never meshes uncovered area).
    """
    r_sample = mat_float(cfg, "p_sample", "r")
    r_ins_oside = mat_float(cfg, "o_ins", "r")
    r_coupler = mat_float(cfg, "p_coupler", "r")
    r_ins_pside = mat_float(cfg, "p_ins", "r")

    z_ins_oside = mat_float(cfg, "o_ins", "z")
    z_ins_pside = mat_float(cfg, "p_ins", "z")
    z_sample = mat_float(cfg, "p_sample", "z")
    z_coupler = mat_float(cfg, "p_coupler", "z")

    zmin = -(z_sample / 2) - z_ins_pside - z_coupler
    zmax = (z_sample / 2) + z_ins_oside + z_coupler
    rmin = 0.0
    rmax = r_sample + r_ins_oside

    b_p_ins = [zmin, zmin + z_ins_pside, rmin, rmin + r_ins_pside]
    b_p_coupler = [b_p_ins[1], b_p_ins[1] + z_coupler, rmin, rmin + r_coupler]
    b_sample = [b_p_coupler[1], b_p_coupler[1] + z_sample, rmin, rmin + r_sample]
    b_o_coupler = [b_sample[1], b_sample[1] + z_coupler, rmin, rmin + r_coupler]
    b_o_ins = [b_o_coupler[1], b_o_coupler[1] + z_ins_oside, rmin,
               rmin + r_ins_oside]

    mats = [
        _mat_spec(cfg, "p_ins", b_p_ins),
        _mat_spec(cfg, "p_coupler", b_p_coupler),
        _mat_spec(cfg, "p_sample", b_sample),
        _mat_spec(cfg, "o_coupler", b_o_coupler),
        _mat_spec(cfg, "o_ins", b_o_ins),
    ]
    return (zmin, zmax, rmin, rmax), mats


def layout_with_diamond(cfg: dict):
    """Derive the 9-material full-DAC stack (ref: run_with_diamond.py:58-181)."""
    r_sample = mat_float(cfg, "p_sample", "r")
    r_gasket = mat_float(cfg, "gasket", "r")
    r_ins_gside = mat_float(cfg, "g_ins", "r")
    r_diamond = r_sample + r_gasket + r_ins_gside  # culets span full r extent

    # insulators and couplers share the sample's radial extent
    r_ins_oside = r_sample
    r_ins_pside = r_sample
    r_coupler = r_sample

    z_ins_oside = mat_float(cfg, "o_ins", "z")
    z_ins_pside = mat_float(cfg, "p_ins", "z")
    z_sample = mat_float(cfg, "p_sample", "z")
    z_coupler = mat_float(cfg, "p_coupler", "z")
    z_diam = mat_float(cfg, "p_diam", "z")

    zmin = -(z_sample / 2) - z_ins_pside - z_coupler - z_diam
    zmax = (z_sample / 2) + z_ins_oside + z_coupler + z_diam
    rmin, rmax = 0.0, r_diamond

    b_p_diam = [zmin, zmin + z_diam, rmin, rmax]
    b_o_diam = [zmax - z_diam, zmax, rmin, rmax]
    b_p_ins = [b_p_diam[1], b_p_diam[1] + z_ins_pside, rmin, rmin + r_ins_pside]
    b_o_ins = [b_o_diam[0] - z_ins_oside, b_o_diam[0], rmin, rmin + r_ins_oside]
    b_p_coupler = [b_p_ins[1], b_p_ins[1] + z_coupler, rmin, rmin + r_coupler]
    b_o_coupler = [b_o_ins[0] - z_coupler, b_o_ins[0], rmin, rmin + r_coupler]
    b_sample = [b_p_coupler[1], b_p_coupler[1] + z_sample, rmin, rmin + r_sample]
    b_g_ins = [b_p_diam[1], b_o_diam[0], rmin + r_sample,
               rmin + r_sample + r_ins_gside]
    b_gasket = [b_p_diam[1], b_o_diam[0], b_g_ins[3], rmax]

    mats = [
        _mat_spec(cfg, "p_diam", b_p_diam),
        _mat_spec(cfg, "p_ins", b_p_ins),
        _mat_spec(cfg, "p_coupler", b_p_coupler),
        _mat_spec(cfg, "p_sample", b_sample),
        _mat_spec(cfg, "o_coupler", b_o_coupler),
        _mat_spec(cfg, "o_ins", b_o_ins),
        _mat_spec(cfg, "o_diam", b_o_diam),
        _mat_spec(cfg, "gasket", b_gasket),
        _mat_spec(cfg, "g_ins", b_g_ins),
    ]
    return (zmin, zmax, rmin, rmax), mats


def layout_custom(cfg: dict):
    """Free-form layout: every material carries explicit ``bounds:
    [zmin, zmax, rmin, rmax]`` in the config.

    This is the YAML form of the reference's raw ``Material(name, bounds,
    props, mesh_size)`` API (ref mesh_and_materials/materials.py:16-34),
    which its notebooks use to build stacks the two canonical layouts can't
    express — e.g. the IR-absorber sample stacks of with_ir_steady.ipynb /
    clean_with_ir.ipynb (hand-computed ``bx_*``/``BX_*`` bounds cells).
    Such configs should also set ``heating.z`` (and optionally
    ``heating.r_max``) — see :func:`heating_line`.
    """
    mats = []
    for name, m in cfg["mats"].items():
        if "bounds" not in m:
            raise ValueError(
                f"custom layout: mats.{name} needs explicit 'bounds' "
                "[zmin, zmax, rmin, rmax]")
        bounds = [float(b) for b in m["bounds"]]
        if len(bounds) != 4:
            raise ValueError(f"mats.{name}.bounds must have 4 entries")
        mats.append(_mat_spec(cfg, name, bounds))
    zmin = min(m.bounds[0] for m in mats)
    zmax = max(m.bounds[1] for m in mats)
    rmin = min(m.bounds[2] for m in mats)
    rmax = max(m.bounds[3] for m in mats)
    return (zmin, zmax, rmin, rmax), mats


def build_layout(cfg: dict, kind: str = "auto"):
    """Return (domain_bounds, materials) for a config.

    kind: 'auto' (explicit bounds → custom; else detect p_diam,
    ref: parameter_sweep.py:91), 'no_diamond', 'with_diamond', or 'custom'.
    """
    if kind == "auto":
        if any("bounds" in m for m in cfg["mats"].values()):
            kind = "custom"
        else:
            kind = "with_diamond" if "p_diam" in cfg["mats"] else "no_diamond"
    if kind == "no_diamond":
        return layout_no_diamond(cfg)
    if kind == "with_diamond":
        return layout_with_diamond(cfg)
    if kind == "custom":
        return layout_custom(cfg)
    raise ValueError(f"unknown layout kind {kind!r}")


def heating_line(cfg: dict, materials: list[MaterialSpec] | None = None
                 ) -> tuple[float, float | None]:
    """(coord, length) of the Gaussian heating Dirichlet line.

    Default: the p-side coupler's left edge, clipped to ±r_sample
    (ref run_no_diamond.py:315-322). Config overrides ``heating.z`` (axial
    position) and ``heating.r_max`` (clip radius; length = 2·r_max) serve
    free-form stacks, which have no canonical coupler — the knobs the
    reference's notebooks set by hand (e.g. clean_with_ir.ipynb's Gaussian
    cell). length None means an unclipped line (the RowDirichletBC default,
    ref dirichlet_bc/bc.py:32-101).
    """
    heat = cfg.get("heating", {})
    coord = float(heat["z"]) if "z" in heat else None
    length = 2.0 * abs(float(heat["r_max"])) if "r_max" in heat else None
    by_name = {m.name: m for m in (materials or [])}

    if coord is None:
        if "p_coupler" in by_name:
            coord = by_name["p_coupler"].bounds[0]
        elif "p_coupler" in cfg["mats"]:
            # cfg-scalar derivation (unstructured meshes carry no
            # MaterialSpec list): zmin + z_diam + z_ins_pside
            z_sample = mat_float(cfg, "p_sample", "z")
            z_ins_pside = mat_float(cfg, "p_ins", "z")
            z_coupler = mat_float(cfg, "p_coupler", "z")
            z_diam = (mat_float(cfg, "p_diam", "z")
                      if "p_diam" in cfg["mats"] else 0.0)
            zmin = -(z_sample / 2) - z_ins_pside - z_coupler - z_diam
            coord = zmin + z_diam + z_ins_pside
        else:
            raise ValueError(
                "cannot derive the heating line: config has no p_coupler — "
                "set heating.z explicitly (custom layouts)")
    if length is None:
        if "p_sample" in by_name:
            b = by_name["p_sample"].bounds
            length = 2.0 * (b[3] - b[2])
        elif "p_sample" in cfg["mats"] and "bounds" not in cfg["mats"]["p_sample"]:
            length = 2.0 * abs(mat_float(cfg, "p_sample", "r"))
        # else: unclipped heating line (documented custom-layout default)
    return coord, length


def validate_layout(domain_bounds, materials: list[MaterialSpec]) -> None:
    """Reject duplicate or degenerate rectangles (ref: mesh.py:46-77)."""
    seen = {tuple(round(b, 12) for b in domain_bounds): "DOMAIN"}
    for m in materials:
        key = tuple(round(b, 12) for b in m.bounds)
        if key in seen:
            raise ValueError(
                f"duplicate rectangle: {m.name} has bounds already used by "
                f"{seen[key]}")
        seen[key] = m.name
    # degenerate rectangles are rejected by MaterialSpec.__post_init__


def coupler_watcher_points(cfg: dict) -> dict[str, tuple[float, float]]:
    """Watcher points at the center of each coupler layer on the axis.

    Diamond-aware, matching the reference sweep's helper
    (ref: parameter_sweep.py:69-120, no_diamond.py:16-38).
    """
    z_sample = mat_float(cfg, "p_sample", "z")
    z_ins_pside = mat_float(cfg, "p_ins", "z")
    z_ins_oside = mat_float(cfg, "o_ins", "z")
    z_coupler = mat_float(cfg, "p_coupler", "z")

    if "p_diam" in cfg["mats"]:
        z_diam = mat_float(cfg, "p_diam", "z")
        zmin = -(z_sample / 2) - z_ins_pside - z_coupler - z_diam
        zmax = (z_sample / 2) + z_ins_oside + z_coupler + z_diam
        p_ins_end = zmin + z_diam + z_ins_pside
        o_ins_start = zmax - z_diam - z_ins_oside
    else:
        zmin = -(z_sample / 2) - z_ins_pside - z_coupler
        zmax = (z_sample / 2) + z_ins_oside + z_coupler
        p_ins_end = zmin + z_ins_pside
        o_ins_start = zmax - z_ins_oside

    return {
        "pside": (p_ins_end + z_coupler / 2, 0.0),
        "oside": (o_ins_start - z_coupler / 2, 0.0),
    }
