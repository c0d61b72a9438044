"""Build-on-demand of the package's CUDA sources and their ctypes binding,
and of the host C++ mesh kernels.

``csrc/*.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, at first use, under
``build/heatflow_tpu_torch/`` beside the package; the file name carries a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one loads the cached library. ``csrc/meshkernel.cpp`` is host code: it is
built apart, with ``g++`` (:func:`build_native`), into the same directory
under the same naming rule. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "heatflow_tpu_torch")
MESH_SRC = os.path.join(CSRC, "meshkernel.cpp")
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
build_info: dict = {}


def find_nvcc() -> str:
    """nvcc from PyTorch's CUDA_HOME, else from PATH; raises if missing."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in CUDA_HOME and PATH): "
                           "the CUDA kernels cannot be built")
    return found


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhf_cuda_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if the hashed library is missing; returns its path
    and records the compile time and the ptxas report in ``build_info``."""
    so = library_path()
    if os.path.exists(so):
        build_info.update(path=so, seconds=0.0, cached=True)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{so}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for i, src in enumerate(_sources()):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", f"{tag}.{i}.o", src]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE,
                                           text=True)))
    ptxas = []
    failed = []
    for cmd, proc in jobs:
        _out, err = proc.communicate()
        ptxas.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    objs = [cmd[cmd.index("-o") + 1] for cmd, _ in jobs]
    link = [nvcc, "-shared", "-o", f"{tag}.tmp", *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(link)}\n{proc.stderr}")
    os.replace(f"{tag}.tmp", so)
    for obj in objs:
        os.remove(obj)
    build_info.update(path=so, seconds=time.perf_counter() - t0,
                      cached=False, ptxas="".join(ptxas))
    return so


def find_cxx() -> str | None:
    """The host C++ compiler on PATH (``g++``, else ``c++``), or None."""
    return shutil.which("g++") or shutil.which("c++")


def native_library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(MESH_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhf_mesh_{h.hexdigest()[:16]}.so")


def build_native() -> str:
    """Compile ``csrc/meshkernel.cpp`` with the host C++ compiler if the
    hashed library is missing; returns its path. Raises if there is no
    compiler or the compile fails."""
    so = native_library_path()
    if os.path.exists(so):
        return so
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the "
                           "native mesh kernels cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, MESH_SRC, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cxx)} failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


def _sig(fn, *argtypes):
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, with argtypes set:
    every pointer and the stream as ``c_void_p``, every count as ``c_int``,
    the damping factors as ``c_float``."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    solve = [P, I, P, P, P, P, P, P, I, P, P, P, P, P, P, I, P, I, I, I, I,
             P, P, I, I, P, P, P, I, F, F, P, P, I]
    _sig(lib.hf_cg_nparts, I, I)
    _sig(lib.hf_cg_state_bytes)
    _sig(lib.hf_num_phases)
    _sig(lib.hf_cg_tol_graph, *solve, I, I, P, P, P, P)
    _sig(lib.hf_solve_desc_bytes)
    _sig(lib.hf_solve_desc, *solve, P)
    _sig(lib.hf_graph_launch, P, P)
    _sig(lib.hf_graph_destroy, P)
    _sig(lib.hf_stencil_dot, P, I, P, P, P, P, P, I, I, P, P)
    _sig(lib.hf_rline_factor, P, P, P, P, I, I, P)
    _sig(lib.hf_update_pcr, P, P, P, P, P, P, P, I, P, P, I, P, I, I, I, I,
         P, P)
    _sig(lib.hf_pcr_r, P, P, P, P, P, I, I, P, P)
    _sig(lib.hf_pcr_z, P, P, P, I, P, P, I, I, P, P)
    _sig(lib.hf_cg_extra_planes, I, I, I)
    _sig(lib.hf_precond_apply, P, I, P, P, P, P, P, I, I, I, P, P, P, I, P,
         P, P, I, F, F, P, P)
    _sig(lib.hf_mgz_pre, P, P, P, P, P, F, P, P, P, I, I, P, P)
    _sig(lib.hf_mgz_coarse, P, I, P, P, P, P, P, F, P, P, I, I, P, P)
    _sig(lib.hf_mgz_coarse_res, P, P, P, P, F, P, I, I, P, P)
    _sig(lib.hf_mgz_prolong_res, P, I, P, P, P, P, P, P, P, I, I, P, P)
    _sig(lib.hf_mgz_post, P, P, P, F, P, P, P, P, I, I, P, I, I, I, I, P, P)
    _sig(lib.hf_merged_w, P, I, P, P, P, P, P, I, I, I, P, P)
    _sig(lib.hf_finalize_merged, P, P, I, I, I, I, P, I, I, P, P)
    _sig(lib.hf_pq_update, P, P, P, P, P, I, P, P)
    _sig(lib.hf_mg_desc_bytes)
    _sig(lib.hf_mg_step, P, P, I, P, P, P, P, I, F, F, F, P, P, P, I, P, P, P,
         P, P, P, P, P, P, I, I, I, I, I, I, P, P)
    _sig(lib.hf_mg_restrict_res, P, I, P, P, P, P, P, I, I, I, I, P, P)
    _sig(lib.hf_mg_last, P, P, P, P, P, P)
    _sig(lib.hf_mg_vcycle, P, P, P, P, P, P, P)
    # csrc/step.cu
    _sig(lib.hf_step_args_bytes)
    _sig(lib.hf_step_state_bytes)
    _sig(lib.hf_step_prologue, P, P)
    _sig(lib.hf_refine_residual, P, I, P)
    _sig(lib.hf_refine_scale, P, I, P)
    _sig(lib.hf_step_epilogue, P, P)
    _sig(lib.hf_step_graph, P, P, I, I, P, P, P)
    # csrc/sweep_cg.cu
    sweep = [P, P, I, P, P, I, P, P, P, P, P, P, P, P, P, I, P, P, I, I, I,
             I, I, I, I, I, P, P, P, I, P, P, P]
    _sig(lib.hf_sweep_tiles, I, I)
    _sig(lib.hf_sweep_tiles2d, I, I)
    _sig(lib.hf_sweep_z_tiles, I, I)
    _sig(lib.hf_sweep_nparts, I, I)
    _sig(lib.hf_sweep_n_rz, I, I, I, I)
    _sig(lib.hf_sweep_state_bytes)
    _sig(lib.hf_sweep_num_phases)
    _sig(lib.hf_sweep_start, *sweep)
    _sig(lib.hf_sweep_iterate, *sweep, I, I)
    _sig(lib.hf_sweep_compact, P, I, P, P, P, P)
    _sig(lib.hf_sweep_finish, P, P, P, I, I, I, I, P, P)
    _sig(lib.hf_sweep_init, P, P, I, P, P, I, P, P, P, P, P, P, I, I, I, I,
         I, P, P, P, I, I, I, P, P)
    _sig(lib.hf_sweep_stencil_dot, P, P, I, P, P, I, P, P, P, P, I, I, I, I,
         I, P, P, P, P)
    _sig(lib.hf_sweep_update, P, P, P, P, P, P, P, I, P, I, I, I, I, I, I,
         I, P, P)
    _sig(lib.hf_sweep_pcr_r, P, P, P, P, I, P, P, P, P, I, I, I, I, I, P, P,
         P, I, I, I, P, P)
    _sig(lib.hf_sweep_pcr_r_update, P, P, P, P, I, P, P, P, P, P, P, P, P, I,
         I, P, I, I, I, I, I, I, I, P, P)
    _sig(lib.hf_sweep_pcr_z, P, P, P, P, I, P, P, P, P, I, I, I, I, I, P, P)
    _sig(lib.hf_sweep_finalize, P, P, I, I, I, I, I, P, I, I, I, P, I, P, P)
    _sig(lib.hf_sweep_p_update, P, P, P, P, I, I, I, I, P, P)
    _sig(lib.hf_sweep_merged_w, P, P, I, P, P, I, P, P, P, P, P, I, I, I, I,
         I, P, P, I, I, P, P)
    _sig(lib.hf_sweep_finalize_merged, P, P, I, I, I, I, I, P, I, I, P, I, P,
         P)
    _sig(lib.hf_sweep_pq_update, P, P, P, P, P, P, I, I, I, P, P)
    _lib = lib
    return _lib
