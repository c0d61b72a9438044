"""Dirichlet boundary-condition masks and the experimental heating curve.

Reproduces the geometric DOF-location semantics of the reference's
RowDirichletBC (ref: dirichlet_bc/bc.py:32-118): locations 'left'/'right'
(z extremes), 'bottom'/'top' (r extremes), 'outer' (all four), and inner
lines 'x'/'y' at a given coordinate, optionally clipped to a centred segment
of given length (tolerance +1e-14). Default geometric width is 1e-10.
"""

from __future__ import annotations

import csv
import math
import re
from dataclasses import dataclass

import numpy as np

DEFAULT_WIDTH = 1e-10


def _close(vals: np.ndarray, target: float, width: float) -> np.ndarray:
    # np.isclose(vals, target, atol=width, rtol=1e-05), as the reference
    return np.isclose(vals, target, atol=width)


def _centred(vals: np.ndarray, center: float, length: float | None) -> np.ndarray:
    if length is None:
        return np.ones_like(vals, dtype=bool)
    return np.abs(vals - center) <= 0.5 * length + 1e-14


def structured_row_mask(z: np.ndarray, r: np.ndarray, location: str, *,
                        coord: float | None = None,
                        center: float | None = None,
                        length: float | None = None,
                        width: float = DEFAULT_WIDTH) -> np.ndarray:
    """(Nz, Nr) boolean mask of boundary nodes for a RowDirichletBC location."""
    zmin, zmax = z.min(), z.max()
    rmin, rmax = r.min(), r.max()
    zmid, rmid = 0.5 * (zmin + zmax), 0.5 * (rmin + rmax)

    if location == "left":
        return np.outer(_close(z, zmin, width), _centred(r, rmid, length))
    if location == "right":
        return np.outer(_close(z, zmax, width), _centred(r, rmid, length))
    if location == "bottom":
        return np.outer(_centred(z, zmid, length), _close(r, rmin, width))
    if location == "top":
        return np.outer(_centred(z, zmid, length), _close(r, rmax, width))
    if location == "outer":
        m = structured_row_mask(z, r, "left", length=length, width=width)
        for loc in ("right", "bottom", "top"):
            m = m | structured_row_mask(z, r, loc, length=length, width=width)
        return m
    if location == "x":
        if coord is None:
            raise ValueError("coord required for location='x'")
        # the reference defaults the clipping center of an 'x' line to the
        # *z* midpoint even though clipping runs along r (bc.py:47-48); every
        # caller passes center explicitly, the quirk is kept for parity
        ctr = zmid if center is None else center
        return np.outer(_close(z, float(coord), width), _centred(r, ctr, length))
    if location == "y":
        if coord is None:
            raise ValueError("coord required for location='y'")
        ctr = rmid if center is None else center
        return np.outer(_centred(z, ctr, length), _close(r, float(coord), width))
    raise ValueError(f"unknown BC location {location!r}")


def node_row_mask(nodes: np.ndarray, location: str, *,
                  coord: float | None = None, center: float | None = None,
                  length: float | None = None,
                  width: float = DEFAULT_WIDTH) -> np.ndarray:
    """(N,) boolean mask over arbitrary (z, r) node arrays — the unstructured
    counterpart of :func:`structured_row_mask`, matching RowDirichletBC's
    geometric predicates verbatim (ref bc.py:56-101)."""
    z, r = nodes[:, 0], nodes[:, 1]
    zmin, zmax = z.min(), z.max()
    rmin, rmax = r.min(), r.max()
    zmid, rmid = 0.5 * (zmin + zmax), 0.5 * (rmin + rmax)

    if location == "left":
        return _close(z, zmin, width) & _centred(r, rmid, length)
    if location == "right":
        return _close(z, zmax, width) & _centred(r, rmid, length)
    if location == "bottom":
        return _close(r, rmin, width) & _centred(z, zmid, length)
    if location == "top":
        return _close(r, rmax, width) & _centred(z, zmid, length)
    if location == "outer":
        out = np.zeros(len(nodes), bool)
        for loc in ("left", "right", "bottom", "top"):
            out |= node_row_mask(nodes, loc, length=length, width=width)
        return out
    if location == "x":
        if coord is None:
            raise ValueError("coord required for location='x'")
        ctr = zmid if center is None else center  # reference quirk, bc.py:47
        return _close(z, float(coord), width) & _centred(r, ctr, length)
    if location == "y":
        if coord is None:
            raise ValueError("coord required for location='y'")
        ctr = rmid if center is None else center
        return _close(r, float(coord), width) & _centred(z, ctr, length)
    raise ValueError(f"unknown BC location {location!r}")


_POW10 = [float(f"1e{k}") for k in range(309)]
_NUMBER = re.compile(r"\s*([-+]?)(\d*)(?:\.(\d*))?(?:[eE]([-+]?\d+))?\s*")


def _to_float(tok: str) -> float:
    """One CSV cell as pandas' C reader converts it (its default "high"
    precision converter), NaN if the cell is not a number.

    That converter is not correctly rounded: it accumulates up to 17
    significant digits in a double and scales by a power of ten, so a
    long decimal can land one ulp away from ``float(tok)``. Replicating it
    keeps the heating curve bit-identical to the reference's."""
    m = _NUMBER.fullmatch(tok)
    if m is None or not (m.group(2) or m.group(3)):
        try:                     # nan / inf spellings
            return float(tok)
        except ValueError:
            return float("nan")
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in frac or "":
        if digits >= 17:
            break
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        exponent -= 1
    if sign == "-":
        number = -number
    if exp:
        exponent += int(exp[:18] if exp[0] not in "+-" else exp[:19])
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


@dataclass
class HeatingCurve:
    """Experimental heating trace driving the laser boundary condition.

    CSV schema: columns 'time' and 'temp' (plus optional 'oside' used by the
    analysis layer), ref run_no_diamond.py:204-224. Cells are coerced to
    numbers, rows whose time or temp is not numeric are dropped, and the rest
    are sorted by time (stable), matching the reference's cleaning.
    """

    time: np.ndarray
    temp: np.ndarray
    oside: np.ndarray | None = None

    @classmethod
    def from_csv(cls, path: str) -> "HeatingCurve":
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        if not rows:
            raise ValueError(f"Heating CSV {path} is empty")
        header = [h.strip() for h in rows[0]]
        for col in ("time", "temp"):
            if col not in header:
                raise ValueError(
                    f"Heating CSV {path} must contain a '{col}' column")
        cols = {name: np.array([_to_float(row[i]) if i < len(row)
                                else float("nan") for row in rows[1:]
                                if any(cell.strip() for cell in row)],
                               dtype=np.float64)
                for i, name in enumerate(header)
                if name in ("time", "temp", "oside")}
        keep = ~(np.isnan(cols["time"]) | np.isnan(cols["temp"]))
        order = np.argsort(cols["time"][keep], kind="stable")
        pick = lambda name: cols[name][keep][order]
        return cls(time=pick("time"), temp=pick("temp"),
                   oside=pick("oside") if "oside" in cols else None)

    def amplitude_offset(self, ic_temp: float) -> float:
        """offset = temp[0] - ic so heating starts at the initial condition
        (ref run_no_diamond.py:299-301)."""
        return float(self.temp[0]) - float(ic_temp)



def gaussian_coeff(fwhm):
    """-4 ln2 / FWHM² (ref run_no_diamond.py:304)."""
    return -4.0 * np.log(2.0) / (fwhm ** 2)


def describe_row_bcs(masks: dict[str, np.ndarray], nodes: np.ndarray, *,
                     label: str = "Row BC") -> list[str]:
    """Print coordinate bounds for each named BC mask — the debugging helper
    of ref bc.py:152-174. ``masks``: name -> (N,) or (Nz, Nr) boolean;
    ``nodes``: (N, 2) coordinates. Returns the printed lines."""
    lines = []
    for k, (name, mask) in enumerate(masks.items()):
        sel = nodes[np.asarray(mask).ravel().astype(bool)]
        if sel.size == 0:
            line = f"{label} #{k} ({name}): no DOFs"
        else:
            line = (f"{label} #{k} ({name}): "
                    f"x in [{sel[:, 0].min():.3e}, {sel[:, 0].max():.3e}]  "
                    f"y in [{sel[:, 1].min():.3e}, {sel[:, 1].max():.3e}]  "
                    f"(n = {len(sel)} DOFs)")
        print(line)
        lines.append(line)
    return lines
