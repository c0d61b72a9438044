"""Frozen copy of ``heatflow_tpu_torch/mesh/axes.py`` for the plain
reference.

Graded 1D axis generation for tensor-product meshes.

Plays the role of gmsh's Box mesh-size fields combined with a Min field
(ref: mesh_and_materials/mesh.py:129-144): inside each material interval the
spacing is at most the material's target size; where material intervals
overlap the minimum wins; outside all materials the default (max of material
sizes) applies.
"""

from __future__ import annotations

import numpy as np


def _merge_breakpoints(lo: float, hi: float, spans) -> np.ndarray:
    """Sorted unique breakpoints of [lo, hi] at every span edge."""
    pts = [lo, hi]
    for a, b, _h in spans:
        for p in (a, b):
            if lo < p < hi:
                pts.append(p)
    pts = np.array(sorted(pts))
    # collapse numerically-identical breakpoints (1 pm resolution like the
    # reference's duplicate check, ref: mesh.py:55)
    keep = [pts[0]]
    scale = max(abs(lo), abs(hi), 1e-30)
    for p in pts[1:]:
        if p - keep[-1] > 1e-12 * scale:
            keep.append(p)
    return np.asarray(keep, dtype=np.float64)


def graded_axis(lo: float, hi: float, spans, default_size: float | None = None
                ) -> np.ndarray:
    """Build a graded 1D axis over [lo, hi].

    Parameters
    ----------
    spans : iterable of (a, b, h)
        Intervals with target spacing ``h``. Sizing at a point is the min of
        all covering spans, else ``default_size``.
    default_size : float, optional
        Spacing outside all spans. Defaults to max span size (matching the
        reference's coarse default, ref: mesh.py:97-99).

    Returns
    -------
    np.ndarray
        Strictly increasing coordinates including both endpoints. Each
        sub-interval between breakpoints is subdivided uniformly with
        n = ceil(length / h) cells.
    """
    if hi <= lo:
        raise ValueError(f"empty axis range [{lo}, {hi}]")
    spans = [(float(a), float(b), float(h)) for a, b, h in spans]
    if default_size is None:
        if not spans:
            raise ValueError("need default_size when no spans are given")
        default_size = max(h for _a, _b, h in spans)

    brk = _merge_breakpoints(lo, hi, spans)
    coords = [brk[0]]
    for a, b in zip(brk[:-1], brk[1:]):
        mid = 0.5 * (a + b)
        h = min((s_h for s_a, s_b, s_h in spans if s_a <= mid <= s_b),
                default=default_size)
        n = max(1, int(np.ceil((b - a) / h - 1e-9)))
        seg = np.linspace(a, b, n + 1)[1:]
        coords.extend(seg.tolist())
    out = np.asarray(coords, dtype=np.float64)
    if not np.all(np.diff(out) > 0):
        raise RuntimeError("graded_axis produced non-monotonic coordinates")
    return out
