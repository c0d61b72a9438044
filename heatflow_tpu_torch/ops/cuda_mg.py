"""Multigrid-preconditioned tolerance CG for one problem: the host setup, the
CUDA kernel path (``csrc/cg_tol.cu``, the V-cycle as one more preconditioner
of the ``cg_tol`` solve loop) and its plain PyTorch version.

Replaces heatflow_tpu/ops/pallas_mg.py (``build_mg_setup``, ``_mgcg_kernel``,
``mgcg_vmem_tol``). The CG operator is the on-the-fly scaled sm·A·(sm·y); the
preconditioner is a V-cycle over *baked* scaled operators (the fine level's
7 planes, then Galerkin 9-plane coarse levels), each level smoothed by a
fixed Chebyshev polynomial in D⁻¹C over [0.08, 1.05]·λmax (λmax a host-side
Gershgorin bound), with bilinear factor-2 transfers. Every level is padded
to odd sizes with inert identity rows, as the TPU scheme needs for its
reshape transfers; the port keeps the padded shapes so that it gives that
scheme's numbers, but moves data between levels with strided gathers.

:func:`build_mg_setup` is numpy and scipy on the host, once per operator.
:func:`mgcg_vmem_tol` takes the plain version :func:`mgcg_tol_reference` for
tensors on the CPU and the kernels for float32 CUDA tensors, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from heatflow_tpu_torch.ops import cuda_cg
from heatflow_tpu_torch.ops.cuda_cg import (_check, _counts_ptr, _library,
                                            _on_cpu, _ptr, _require, _stream)
from heatflow_tpu_torch.ops.stencil import (apply_stencil, offsets_for,
                                            sparse_to_stencil, stencil_to_coo)
from heatflow_tpu_torch.utils import resolve_device

CHEB_LO_FRAC = 0.08
CHEB_HI_FRAC = 1.05
MAX_LEVELS = 8     # csrc/cg_tol.cu: kMaxLevels
MAX_CHEB = 32      # csrc/cg_tol.cu: kMaxCheb


# ----------------------------------------------------------------------
# host-side setup
# ----------------------------------------------------------------------

def _pad_odd(n: int) -> int:
    return n if n % 2 == 1 else n + 1


def _axis_weights(axis: np.ndarray) -> np.ndarray:
    """w[i] for fine node 2i+1 between coarse nodes i, i+1 (odd-sized axis):
    value = w·c_i + (1-w)·c_{i+1}."""
    zc = axis[0::2]
    zo = axis[1::2]
    denom = zc[1:] - zc[:-1]
    return (zc[1:] - zo) / np.where(denom != 0, denom, 1.0)


def _transfer_matrix(axis: np.ndarray):
    """Sparse 1D bilinear P (n_fine, n_coarse) for factor-2 coarsening of an
    odd-sized axis: the matrix of :func:`prolong2d` along one axis."""
    import scipy.sparse as sp
    n = len(axis)
    m = (n + 1) // 2
    w = _axis_weights(axis)
    rows = np.concatenate([np.arange(0, n, 2),
                           np.arange(1, n, 2), np.arange(1, n, 2)])
    cols = np.concatenate([np.arange(m),
                           np.arange(m - 1), np.arange(1, m)])
    vals = np.concatenate([np.ones(m), w, 1.0 - w])
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()


def _pad_op(C: np.ndarray, shape_to: tuple[int, int]) -> np.ndarray:
    """Pad a stencil with identity rows: zero couplings, unit diagonal."""
    out = np.zeros((C.shape[0],) + tuple(shape_to))
    out[:, :C.shape[1], :C.shape[2]] = C
    out[0, C.shape[1]:, :] = 1.0
    out[0, :, C.shape[2]:] = 1.0
    return out


def _bake(C: np.ndarray, fmask: np.ndarray, svec: np.ndarray) -> np.ndarray:
    """The scaled operator sf·C·sf (sf = svec·fmask) as coefficients, with
    unit diagonals at constrained nodes."""
    sf = svec * fmask
    out = np.zeros_like(C)
    npz, npr = C.shape[1:]
    for k, (di, dj) in enumerate(offsets_for(C.shape[0])):
        shifted = np.zeros((npz, npr))
        zs = slice(max(0, di), npz + min(0, di))
        zd = slice(max(0, -di), npz + min(0, -di))
        rs = slice(max(0, dj), npr + min(0, dj))
        rd = slice(max(0, -dj), npr + min(0, -dj))
        shifted[zd, rd] = sf[zs, rs]
        out[k] = C[k] * sf * shifted
    out[0] += (1.0 - fmask)
    return out


def build_mg_setup(A: np.ndarray, free: np.ndarray, z: np.ndarray,
                   r: np.ndarray, *, n_levels: int = 4,
                   dtype: torch.dtype = torch.float32,
                   device="cuda") -> dict:
    """Precompute everything the solve needs.

    A: (7|9, Nz, Nr) unscaled implicit operator; free: (Nz, Nr) mask; z/r:
    grid axes. Returns ``A`` (padded to odd sizes) and ``sm`` = s·free, per
    level the baked operator ``C`` and the transfer weights ``wz`` (m−1, 1)
    and ``wr`` (1, m−1), as ``dtype`` tensors on ``device`` (the card unless
    the caller passes ``device='cpu'``), and ``meta`` (the levels' padded
    shapes, their Gershgorin bounds on D⁻¹C, the original and padded fine
    shape). Coarsening stops at ``n_levels`` or when a side is ≤ 9."""
    import scipy.sparse as sp
    device = resolve_device(device)
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"n_levels must be in 1..{MAX_LEVELS}")
    A = np.asarray(A, np.float64)
    free = np.asarray(free, np.float64)
    z, r = np.asarray(z, np.float64), np.asarray(r, np.float64)
    nz, nr = A.shape[-2:]
    pz, pr = _pad_odd(nz), _pad_odd(nr)

    Af = _pad_op(A, (pz, pr))
    freef = np.zeros((pz, pr))
    freef[:nz, :nr] = free
    zf = np.concatenate([z, z[-1:] + (z[-1] - z[-2])]) if pz != nz else z
    rf = np.concatenate([r, r[-1:] + (r[-1] - r[-2])]) if pr != nr else r

    diag = Af[0]
    s = 1.0 / np.sqrt(np.where(diag > 0, diag, 1.0)) * freef \
        + (1.0 - freef)

    levels = []
    cur_z, cur_r, cur_C = zf, rf, _bake(Af, freef, s)
    for lv in range(n_levels):
        npz, npr = len(cur_z), len(cur_r)
        # Gershgorin bound on D⁻¹C (coarse RAP diagonals are not unit)
        dg = np.where(cur_C[0] != 0, cur_C[0], 1.0)
        lmax = float((np.abs(cur_C).sum(axis=0) / dg).max())
        levels.append({"C": cur_C, "lmax": lmax, "shape": (npz, npr),
                       "wz": _axis_weights(cur_z)[:, None],
                       "wr": _axis_weights(cur_r)[None, :]})
        if lv == n_levels - 1 or min(npz, npr) <= 9:
            break
        # Galerkin coarse operator on the strict stride-2 grid
        P = sp.kron(_transfer_matrix(cur_z), _transfer_matrix(cur_r)).tocsr()
        rows, cols, vals = stencil_to_coo(cur_C)
        n_f = npz * npr
        Afine = sp.coo_matrix((vals, (rows, cols)), shape=(n_f, n_f)).tocsr()
        mz, mr = (npz + 1) // 2, (npr + 1) // 2
        Cc = sparse_to_stencil((P.T @ Afine @ P).tocoo(), (mz, mr), 9)
        pmz, pmr = _pad_odd(mz), _pad_odd(mr)
        cz, cr = cur_z[0::2], cur_r[0::2]
        cur_z = np.concatenate([cz, cz[-1:] * 2 - cz[-2:-1]]) \
            if pmz != mz else cz
        cur_r = np.concatenate([cr, cr[-1:] * 2 - cr[-2:-1]]) \
            if pmr != mr else cr
        cur_C = _pad_op(Cc, (pmz, pmr))

    t = lambda v: torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                                  device=device).contiguous()
    return {
        "A": t(Af),
        "sm": t(s * freef),
        "levels": [{k: t(lv[k]) for k in ("C", "wz", "wr")}
                   for lv in levels],
        "meta": {"shapes": [lv["shape"] for lv in levels],
                 "lmaxs": [lv["lmax"] for lv in levels],
                 "orig": (nz, nr), "padded": (pz, pr)},
    }


def cheb_coefficients(lmax: float, steps: int, dtype: torch.dtype):
    """(θ, [(c1, c2), ...]) of ``steps`` Chebyshev steps on [0.08, 1.05]·λmax
    as Python floats, every operation rounded to ``dtype`` as the TPU
    kernel's scalars are: the first step is d = D⁻¹res/θ, step k + 1 is
    d = c1[k]·d + c2[k]·D⁻¹res."""
    f = np.float32 if dtype == torch.float32 else np.float64
    lo, hi = CHEB_LO_FRAC * lmax, CHEB_HI_FRAC * lmax
    theta, delta = f(0.5 * (hi + lo)), f(0.5 * (hi - lo))
    sigma = f(theta / delta)
    rho = f(f(1.0) / sigma)
    coefs = []
    for _ in range(steps - 1):
        rho_new = f(f(1.0) / f(f(f(2.0) * sigma) - rho))
        coefs.append((float(f(rho_new * rho)),
                      float(f(f(f(2.0) * rho_new) / delta))))
        rho = rho_new
    return float(theta), coefs


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def _restrict1d_rows(v, w):
    """Pᵀ of linear interpolation along rows: (2m−1, n) → (m, n); coarse i
    takes fine 2i, then w[i]·(2i+1), then (1−w[i−1])·(2i−1)."""
    ev, od = v[0::2], v[1::2]
    z1 = v.new_zeros((1, v.shape[1]))
    return ev + torch.cat([w * od, z1]) + torch.cat([z1, (1.0 - w) * od])


def _prolong1d_rows(c, w):
    """Linear interpolation along rows: (m, n) → (2m−1, n)."""
    out = c.new_empty((2 * c.shape[0] - 1, c.shape[1]))
    out[0::2] = c
    out[1::2] = w * c[:-1] + (1.0 - w) * c[1:]
    return out


def restrict2d(v, wz, wr):
    """Fine (2mz−1, 2mr−1) → coarse (mz, mr): z, then r."""
    x = _restrict1d_rows(v, wz)
    return _restrict1d_rows(x.T, wr.T).T


def prolong2d(c, wz, wr):
    """Coarse (mz, mr) → fine (2mz−1, 2mr−1): r, then z."""
    x = _prolong1d_rows(c.T, wr.T).T
    return _prolong1d_rows(x, wz)


def _dinv(C):
    d = C[0]
    return torch.where(d != 0, 1.0 / d, torch.ones_like(d))


def mg_cheb_step_reference(C, b, x, d, theta, c1=None, c2=None, *,
                           mask=None, dot=None):
    """Plain version of :func:`mg_cheb_step`."""
    res = b if x is None else b - apply_stencil(C, x)
    if c1 is None:
        d = _dinv(C) * res / theta
    else:
        d = c1 * d + c2 * (_dinv(C) * res)
    x = d if x is None else x + d
    if mask is not None:
        x = x * (mask > 0).to(x.dtype)
    dsum = None if dot is None else (dot.double() * x.double()).sum()
    return x, d, dsum


def _cheb_reference(C, b, x, lmax, degree):
    """``degree`` Chebyshev steps on D⁻¹C from x (None: from zero)."""
    theta, coefs = cheb_coefficients(lmax, degree, b.dtype)
    x, d, _ = mg_cheb_step_reference(C, b, x, None, theta)
    for c1, c2 in coefs:
        x, d, _ = mg_cheb_step_reference(C, b, x, d, theta, c1, c2)
    return x


def mg_restrict_reference(v, wz, wr, out_shape):
    """:func:`restrict2d` zero-padded to the next level's padded shape."""
    rc = restrict2d(v, wz, wr)
    out = v.new_zeros(tuple(out_shape))
    out[:rc.shape[0], :rc.shape[1]] = rc
    return out


def mg_prolong_add_reference(x, xc, wz, wr):
    """x + P·xc, P acting on the unpadded part of the coarse plane."""
    mz, mr = (x.shape[0] + 1) // 2, (x.shape[1] + 1) // 2
    return x + prolong2d(xc[:mz, :mr], wz, wr)


def vcycle_reference(setup: dict, nu: int = 2, nu_coarse: int = 10):
    """The V-cycle over the baked level operators, r ↦ z (unmasked), in the
    levels' dtype, on the padded fine grid."""
    levels, meta = setup["levels"], setup["meta"]
    shapes, lmaxs = meta["shapes"], meta["lmaxs"]
    n_lv = len(levels)

    def vcycle(l, b):
        C = levels[l]["C"]
        if l == n_lv - 1:
            return _cheb_reference(C, b, None, lmaxs[l], nu_coarse)
        wz, wr = levels[l]["wz"], levels[l]["wr"]
        x = _cheb_reference(C, b, None, lmaxs[l], nu)
        res = b - apply_stencil(C, x)
        xc = vcycle(l + 1, mg_restrict_reference(res, wz, wr, shapes[l + 1]))
        x = mg_prolong_add_reference(x, xc, wz, wr)
        return _cheb_reference(C, b, x, lmaxs[l], nu)

    return lambda rr: vcycle(0, rr)


def mg_vcycle_reference(setup: dict, r, *, nu: int = 2, nu_coarse: int = 10):
    """Plain version of :func:`mg_vcycle`: (z, ⟨r, z⟩ float64)."""
    z = vcycle_reference(setup, nu, nu_coarse)(r) \
        * (setup["sm"] > 0).to(r.dtype)
    return z, (r.double() * z.double()).sum()


def _pad_field(v, dtype, nz, nr, pz, pr):
    out = torch.zeros((pz, pr), dtype=dtype, device=v.device)
    out[:nz, :nr] = v.to(dtype)
    return out


def _check_smoothing(nu: int, nu_coarse: int) -> None:
    if not (1 <= nu <= MAX_CHEB and 1 <= nu_coarse <= MAX_CHEB):
        raise ValueError(f"nu and nu_coarse must be in 1..{MAX_CHEB}")


def mgcg_tol_reference(setup: dict, b, x0, rtol, *, maxiter: int = 2000,
                       rtol_wrt: str = "r0", nu: int = 2,
                       nu_coarse: int = 10):
    """Plain PyTorch version of :func:`mgcg_vmem_tol`, in the setup's dtype,
    on the setup's device: the TPU kernel's loop step by step. Returns (x on
    the original grid, iters as a 0-d int32 tensor)."""
    cuda_cg._check_rtol_wrt(rtol_wrt)
    _check_smoothing(nu, nu_coarse)
    meta = setup["meta"]
    (nz, nr), (pz, pr) = meta["orig"], meta["padded"]
    A, sm = setup["A"], setup["sm"]
    dtype = sm.dtype
    b = _pad_field(b, dtype, nz, nr, pz, pr)
    x = _pad_field(x0, dtype, nz, nr, pz, pr)
    fmask = (sm > 0).to(dtype)
    one = torch.ones((), dtype=dtype, device=sm.device)
    apply_op = lambda y: sm * apply_stencil(A, sm * y)
    vcyc = vcycle_reference(setup, nu, nu_coarse)
    precond = lambda rr_: vcyc(rr_) * fmask

    r = b - apply_op(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    rr = torch.sum(r * r)
    rtol = torch.as_tensor(rtol, dtype=dtype, device=sm.device)
    ref2 = rr if rtol_wrt == "r0" else torch.sum(b * b)
    stop2 = rtol * rtol * ref2
    k = 0
    while k < maxiter and bool(rr > stop2):
        Ap = apply_op(p)
        pAp = torch.sum(p * Ap)
        alpha = rz / torch.where(pAp != 0, pAp, one)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(rz != 0, rz, one)
        p = z + beta * p
        rz = rz_new
        rr = torch.sum(r * r)
        k += 1
    return x[:nz, :nr], torch.tensor(k, dtype=torch.int32, device=sm.device)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------

class _MGLevel(ctypes.Structure):
    """Mirror of ``MGLevel`` in csrc/cg_tol.cu."""
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("C", "wz", "wr", "b", "xa", "xb", "d", "res")]
                + [("npts", ctypes.c_int), ("nz", ctypes.c_int),
                   ("nr", ctypes.c_int), ("theta", ctypes.c_float),
                   ("c1", ctypes.c_float * MAX_CHEB),
                   ("c2", ctypes.c_float * MAX_CHEB)])


class _MGDesc(ctypes.Structure):
    """Mirror of ``MGDesc`` in csrc/cg_tol.cu."""
    _fields_ = [("n_levels", ctypes.c_int), ("nu", ctypes.c_int),
                ("nu_coarse", ctypes.c_int), ("reserved", ctypes.c_int),
                ("lv", _MGLevel * MAX_LEVELS)]


def setup_tensors(setup: dict) -> list:
    """Every tensor of a :func:`build_mg_setup` result."""
    return [setup["A"], setup["sm"]] + [lv[k] for lv in setup["levels"]
                                        for k in ("C", "wz", "wr")]


def _descriptor(lib, setup: dict, nu: int, nu_coarse: int, z=None):
    """(descriptor, scratch, result planes) for the cycle of ``setup`` on its
    device: checks the level tensors, allocates each level's scratch planes
    and lays out level 0's two iterate planes so that the cycle's last
    iterate lands in ``z`` (allocated here when None). The caller keeps
    ``scratch`` alive until the launches are enqueued."""
    if ctypes.sizeof(_MGDesc) != lib.hf_mg_desc_bytes():
        raise RuntimeError("csrc/cg_tol.cu and ops/cuda_mg.py disagree on "
                           "the multigrid descriptor's layout")
    _check_smoothing(nu, nu_coarse)
    meta, levels = setup["meta"], setup["levels"]
    dev = setup["sm"].device
    desc = _MGDesc()
    desc.n_levels, desc.nu, desc.nu_coarse = len(levels), nu, nu_coarse
    scratch = []
    for l, (lv, shape) in enumerate(zip(levels, meta["shapes"])):
        lnz, lnr = shape
        C = lv["C"]
        if C.ndim != 3 or C.shape[0] not in (7, 9):
            raise ValueError(f"level {l}: C must be (7|9, nz, nr)")
        _require(C, f"levels[{l}]['C']", (C.shape[0], lnz, lnr), dev)
        _require(lv["wz"], f"levels[{l}]['wz']", ((lnz - 1) // 2, 1), dev)
        _require(lv["wr"], f"levels[{l}]['wr']", (1, (lnr - 1) // 2), dev)
        planes = torch.empty((5, lnz, lnr), dtype=torch.float32, device=dev)
        scratch.append(planes)
        rec = desc.lv[l]
        rec.C, rec.wz, rec.wr = _ptr(C), _ptr(lv["wz"]), _ptr(lv["wr"])
        rec.b, rec.xa, rec.xb, rec.d, rec.res = (_ptr(p) for p in planes)
        rec.npts, rec.nz, rec.nr = C.shape[0], lnz, lnr
        theta, coefs = cheb_coefficients(meta["lmaxs"][l],
                                         max(nu, nu_coarse), torch.float32)
        rec.theta = theta
        for k, (c1, c2) in enumerate(coefs):
            rec.c1[k], rec.c2[k] = c1, c2
    # level 0: the first step from zero writes xa and every step alternates,
    # so the last iterate is in xb after nu + nu steps, or after an even
    # number of steps when level 0 is also the last
    if z is None:
        z = torch.empty(meta["shapes"][0], dtype=torch.float32, device=dev)
    steps = nu_coarse if len(levels) == 1 else 2 * nu
    other = scratch[0][1]
    if steps % 2 == 0:
        desc.lv[0].xa, desc.lv[0].xb = _ptr(other), _ptr(z)
    else:
        desc.lv[0].xa, desc.lv[0].xb = _ptr(z), _ptr(other)
    return desc, scratch, z


def mgcg_vmem_tol(setup: dict, b, x0, rtol, *, maxiter: int = 2000,
                  rtol_wrt: str = "r0", nu: int = 2, nu_coarse: int = 10):
    """Tolerance-based multigrid-preconditioned CG.

    setup: :func:`build_mg_setup` output (its operator must be the one b
    belongs to). b/x0: (Nz, Nr) on the ORIGINAL grid (padded here); they
    must vanish at constrained dofs, as for ``cg_tol``. Stops when
    k ≥ maxiter or ‖r‖ ≤ rtol·‖r0‖ (``rtol_wrt='r0'``) or rtol·‖b‖ (``'b'``).
    Returns (x, iters) with iters a 0-d int32 tensor. A setup on the CPU
    takes the plain version; a float32 setup on a CUDA device the kernels."""
    cuda_cg._check_rtol_wrt(rtol_wrt)
    tensors = setup_tensors(setup)
    if _on_cpu(*tensors, b, x0):
        return mgcg_tol_reference(setup, b, x0, rtol, maxiter=maxiter,
                                  rtol_wrt=rtol_wrt, nu=nu,
                                  nu_coarse=nu_coarse)
    lib = _library()
    meta = setup["meta"]
    (nz, nr), (pz, pr) = meta["orig"], meta["padded"]
    _require(b, "b", (nz, nr), setup["sm"].device)
    _require(x0, "x0", (nz, nr), setup["sm"].device)
    bp = _pad_field(b, torch.float32, nz, nr, pz, pr)
    xp = _pad_field(x0, torch.float32, nz, nr, pz, pr)
    keep = []

    def mg(z):
        desc, scratch, _ = _descriptor(lib, setup, int(nu), int(nu_coarse), z)
        keep.append(scratch)
        return desc

    x, iters = cuda_cg._kernel_solve(
        setup["A"], setup["sm"], bp, xp, rtol, maxiter=maxiter,
        rtol_wrt=rtol_wrt, mg=mg, count=(mgcg_vmem_tol, ["launches"]),
        what="mgcg_vmem_tol")
    return x[:nz, :nr], iters


mgcg_vmem_tol.launches = 0


def reset_counters() -> None:
    """Set this module's and ``cuda_cg``'s launch counts to 0."""
    cuda_cg.reset_counters()
    mgcg_vmem_tol.launches = 0


def mg_vcycle(setup: dict, r, *, nu: int = 2, nu_coarse: int = 10):
    """The preconditioner alone: (z = V-cycle(r)·(sm > 0), ⟨r, z⟩ float64)
    on the padded fine grid, through the kernels the solve launches."""
    if _on_cpu(*setup_tensors(setup), r):
        return mg_vcycle_reference(setup, r, nu=nu, nu_coarse=nu_coarse)
    lib = _library()
    dev = setup["sm"].device
    pz, pr = setup["meta"]["padded"]
    _require(r, "r", (pz, pr), dev)
    _require(setup["sm"], "sm", (pz, pr), dev)
    desc, scratch, z = _descriptor(lib, setup, int(nu), int(nu_coarse))
    nparts = lib.hf_cg_nparts(pz, pr)
    part = torch.zeros(nparts, dtype=torch.float64, device=dev)
    result = ctypes.c_void_p(0)
    _check(lib.hf_mg_vcycle(ctypes.addressof(desc), _ptr(r),
                            _ptr(setup["sm"]), _ptr(part), _counts_ptr(),
                            _stream(), ctypes.addressof(result)),
           "mg_vcycle")
    if result.value != z.data_ptr():
        raise RuntimeError("mg_vcycle: the cycle's last iterate is not in "
                           "the plane laid out for it")
    del scratch
    return z, part[:(pz * pr + 255) // 256].sum()


def mg_cheb_step(C, b, x, d, theta, c1=None, c2=None, *, mask=None,
                 dot=None):
    """One Chebyshev smoothing step of a level alone: res = b − C·x (b when
    x is None), d = D⁻¹res/θ on the first step (``c1 is None``) or
    c1·d + c2·D⁻¹res, x_new = x + d, times (mask > 0) when ``mask`` is
    given. Returns (x_new, d_new, ⟨dot, x_new⟩ float64 or None); the inputs
    are left as they are."""
    if _on_cpu(C, b, x, d, mask, dot):
        return mg_cheb_step_reference(C, b, x, d, theta, c1, c2, mask=mask,
                                      dot=dot)
    lib = _library()
    dev = b.device
    nz, nr = b.shape
    if C.ndim != 3 or C.shape[0] not in (7, 9):
        raise ValueError(f"C must be (7|9, nz, nr), got {tuple(C.shape)}")
    _require(C, "C", (C.shape[0], nz, nr), dev)
    _require(b, "b", (nz, nr), dev)
    for name, t in (("x", x), ("d", d), ("mask", mask), ("dot", dot)):
        if t is not None:
            _require(t, name, (nz, nr), dev)
    first = c1 is None
    if not first and d is None:
        raise ValueError("a later step needs the previous d")
    d_new = torch.empty_like(b) if first else d.clone()
    x_new = torch.empty_like(b)
    part = torch.zeros(lib.hf_cg_nparts(nz, nr), dtype=torch.float64,
                       device=dev)
    _check(lib.hf_mg_cheb(_ptr(C), C.shape[0], _ptr(b), _ptr(x), _ptr(d_new),
                          _ptr(x_new), int(first), float(theta),
                          0.0 if first else float(c1),
                          0.0 if first else float(c2), _ptr(mask), _ptr(dot),
                          _ptr(part), nz, nr, _counts_ptr(), _stream()),
           "mg_cheb")
    dsum = None if dot is None else part[:(nz * nr + 255) // 256].sum()
    return x_new, d_new, dsum


def mg_residual(C, b, x):
    """A level's residual alone: b − C·x."""
    if _on_cpu(C, b, x):
        return b - apply_stencil(C, x)
    lib = _library()
    nz, nr = b.shape
    if C.ndim != 3 or C.shape[0] not in (7, 9):
        raise ValueError(f"C must be (7|9, nz, nr), got {tuple(C.shape)}")
    _require(C, "C", (C.shape[0], nz, nr), b.device)
    _require(b, "b", (nz, nr), b.device)
    _require(x, "x", (nz, nr), b.device)
    out = torch.empty_like(b)
    _check(lib.hf_mg_residual(_ptr(C), C.shape[0], _ptr(b), _ptr(x),
                              _ptr(out), nz, nr, _counts_ptr(), _stream()),
           "mg_residual")
    return out


def _check_transfer(fine_shape, wz, wr, device):
    nz, nr = fine_shape
    if nz % 2 != 1 or nr % 2 != 1:
        raise ValueError(f"the fine grid must have odd sides, got {nz} x {nr}")
    _require(wz, "wz", ((nz - 1) // 2, 1), device)
    _require(wr, "wr", (1, (nr - 1) // 2), device)


def mg_restrict(v, wz, wr, out_shape):
    """The restriction alone: Pᵀv on the next level's padded shape (zeros
    in the padding), each coarse value a gather summed in a fixed order."""
    if _on_cpu(v, wz, wr):
        return mg_restrict_reference(v, wz, wr, out_shape)
    lib = _library()
    nz, nr = v.shape
    _require(v, "v", (nz, nr), v.device)
    _check_transfer((nz, nr), wz, wr, v.device)
    cz, cr = (int(n) for n in out_shape)
    if cz < (nz + 1) // 2 or cr < (nr + 1) // 2:
        raise ValueError(f"out_shape {out_shape} is smaller than the coarse "
                         "grid")
    out = torch.empty((cz, cr), dtype=torch.float32, device=v.device)
    _check(lib.hf_mg_restrict(_ptr(v), _ptr(wz), _ptr(wr), _ptr(out), nz, nr,
                              cz, cr, _counts_ptr(), _stream()),
           "mg_restrict")
    return out


def mg_prolong_add(x, xc, wz, wr):
    """The prolongation alone: x + P·xc (the unpadded part of xc); x is left
    as it is."""
    if _on_cpu(x, xc, wz, wr):
        return mg_prolong_add_reference(x, xc, wz, wr)
    lib = _library()
    nz, nr = x.shape
    _require(x, "x", (nz, nr), x.device)
    _check_transfer((nz, nr), wz, wr, x.device)
    _require(xc, "xc", tuple(xc.shape), x.device)
    if xc.ndim != 2 or xc.shape[0] < (nz + 1) // 2 \
            or xc.shape[1] < (nr + 1) // 2:
        raise ValueError(f"xc {tuple(xc.shape)} is smaller than the coarse "
                         "grid")
    out = x.clone()
    _check(lib.hf_mg_prolong(_ptr(out), _ptr(xc), _ptr(wz), _ptr(wr), nz, nr,
                             xc.shape[1], _counts_ptr(), _stream()),
           "mg_prolong")
    return out
