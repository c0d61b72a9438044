"""The one traffic generator: coefficient draws from a search box.

Every seed gets the same set of draws in another order. The set is the
first ``set_size`` points of the R2 low-discrepancy sequence (Roberts'
generalised golden ratio), mapped log-uniformly onto the box, so it covers
the box evenly; the seed permutes it, and the draws run through the set
cycle after cycle, each cycle in a new order. A window that runs about a
whole set or more therefore does the same work whatever its seed.
"""

from __future__ import annotations

import numpy as np

# the plastic number's powers: the R2 sequence's two increments
_R2 = (0.7548776662466927, 0.5698402909980532)


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use (``stream`` >= 0) of a run's seed; seeds of
    any size, negative ones included."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def box_points(count: int, box: dict) -> dict:
    """The first ``count`` points of the R2 sequence in the box: {name:
    (count,) values} for each ``name: [lo, hi]`` (one or two axes, in the
    order given), log-uniform in [lo, hi]."""
    if not 1 <= len(box) <= 2:
        raise ValueError(f"a search box has one or two axes, got {box}")
    i = np.arange(1, count + 1, dtype=np.float64)
    out = {}
    for axis, (name, (lo, hi)) in enumerate(box.items()):
        u = np.mod(0.5 + i * _R2[axis], 1.0)
        out[name] = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    return out


def draws(seed: int, start: int, count: int, box: dict,
          set_size: int) -> dict:
    """Draws ``start`` .. ``start + count - 1`` of the seed (``start`` may
    be negative: cycle -1, the warm-up's): draw i is point
    ``perm_c[i % set_size]`` of the set, ``perm_c`` the seed's permutation
    for cycle ``c = i // set_size``."""
    points = box_points(set_size, box)
    idx = np.arange(start, start + count)
    cycles = idx // set_size
    pick = np.empty(count, dtype=np.int64)
    for c in np.unique(cycles):
        perm = rng(seed, 1000 + int(c)).permutation(set_size)
        at = cycles == c
        pick[at] = perm[idx[at] % set_size]
    return {name: v[pick] for name, v in points.items()}
