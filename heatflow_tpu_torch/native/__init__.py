"""ctypes binding of the host C++ mesh kernels (``csrc/meshkernel.cpp``):
the graded axis, the cell tags and the exact P1 stencil assembly of a
structured mesh, the counterparts of ``mesh/axes.graded_axis``,
``mesh/structured._assign_cell_tags`` and ``ops/stencil``'s numpy assembly.

The library is built with the host C++ compiler at first use
(``ops/_build.build_native``, into ``build/heatflow_tpu_torch/``). A build
or load failure raises: nothing here falls back to numpy. The choice between
the two paths is ``ops.stencil.assemble_stencils``'s (:func:`available`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from heatflow_tpu_torch.ops import _build

_lib = None


def available() -> bool:
    """Whether ``backend='auto'`` takes the native path: a C++ compiler is on
    PATH and ``HEATFLOW_TPU_NO_NATIVE=1`` is not set."""
    return (os.environ.get("HEATFLOW_TPU_NO_NATIVE") != "1"
            and _build.find_cxx() is not None)


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the library, with argtypes set; raises if
    either step fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build.build_native())
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    L, D = ctypes.c_long, ctypes.c_double
    lib.hf_graded_axis.restype = L
    lib.hf_graded_axis.argtypes = [D, D, f64, L, D, f64, L]
    lib.hf_assign_cell_tags.restype = None
    lib.hf_assign_cell_tags.argtypes = [f64, L, f64, L, f64, L, i32]
    lib.hf_assemble_stencils.restype = None
    lib.hf_assemble_stencils.argtypes = [f64, L, f64, L, i32, L,
                                         f64, f64, f64, f64, f64, f64]
    _lib = lib
    return _lib


def native_graded_axis(lo, hi, spans, default_size) -> np.ndarray:
    """``mesh.axes.graded_axis(lo, hi, spans, default_size)`` in C++."""
    lib = get_lib()
    spans_arr = np.ascontiguousarray(
        [(a, b, h) for a, b, h in spans], dtype=np.float64).reshape(-1, 3)
    cap = 16 + sum(int((b - a) / h) + 4 for a, b, h in spans_arr.tolist())
    cap += int((hi - lo) / default_size) + 4
    out = np.empty(max(cap, 64), dtype=np.float64)
    n = lib.hf_graded_axis(lo, hi, spans_arr.ravel(), len(spans_arr),
                           default_size, out, len(out))
    if n < 0:
        out = np.empty(4 * len(out), dtype=np.float64)
        n = lib.hf_graded_axis(lo, hi, spans_arr.ravel(), len(spans_arr),
                               default_size, out, len(out))
        if n < 0:
            raise RuntimeError(f"hf_graded_axis: more than {len(out)} "
                               "coordinates")
    return out[:n].copy()


def native_assign_cell_tags(z, r, rects) -> np.ndarray:
    """(Nz-1, Nr-1) int32 tags: the first rectangle (zmin, zmax, rmin, rmax)
    holding a cell's centre, 1-based; 0 where none does."""
    lib = get_lib()
    z = np.ascontiguousarray(z, np.float64)
    r = np.ascontiguousarray(r, np.float64)
    rects = np.ascontiguousarray(rects, np.float64).reshape(-1, 4)
    tags = np.zeros((len(z) - 1, len(r) - 1), dtype=np.int32)
    lib.hf_assign_cell_tags(z, len(z), r, len(r), rects.ravel(), len(rects),
                            tags)
    return tags


def native_assemble_stencils(z, r, cell_tags, n_mats):
    """(K, M, K_flat, M_flat, G_r, G_z) of ``ops.stencil.StencilPack`` for
    the grid (z, r) with (Nz-1, Nr-1) tags in 1..n_mats."""
    lib = get_lib()
    z = np.ascontiguousarray(z, np.float64)
    r = np.ascontiguousarray(r, np.float64)
    tags = np.ascontiguousarray(cell_tags, np.int32)
    nz, nr = len(z), len(r)
    if tags.shape != (nz - 1, nr - 1):
        raise ValueError(f"cell_tags {tags.shape} for a {nz} x {nr} grid")
    shape = (n_mats, 7, nz, nr)
    K, M, Kf, Mf = (np.empty(shape) for _ in range(4))
    G_r, G_z = np.empty((7, nz, nr)), np.empty((7, nz, nr))
    lib.hf_assemble_stencils(z, nz, r, nr, tags, n_mats, K, M, Kf, Mf,
                             G_r, G_z)
    return K, M, Kf, Mf, G_r, G_z
