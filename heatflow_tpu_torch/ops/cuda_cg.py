"""Tolerance-stopped PCG on the scaled stencil operator: the CUDA kernel
(``csrc/cg_tol.cu``) and its plain PyTorch version.

``cg_tol`` solves sm·A·sm y = b, with b and x0 vanishing at constrained
dofs and sm = rsqrt(diag(A))·free, preconditioned by nothing, by the r-line
PCR block-Jacobi solve (``pcr``), by the split-additive ADI solve
R r + Z r − r (``pcr`` and ``pcr_z``), by a fixed Chebyshev polynomial in
the operator (``cheb_degree``) or by the z-semicoarsened two-level V-cycle
over the r-line smoother (``mgz``, operands from ``ops/mgz.py``), with the
standard recurrence or the Chronopoulos–Gear merged-dot one (``merged``),
stopping on the true residual
‖r‖ ≤ rtol·‖r0‖ (``rtol_wrt='r0'``) or rtol·‖b‖ (``'b'``). A tensor on the
CPU goes to :func:`cg_tol_reference`; a CUDA tensor goes to the kernel, or
the call raises. The kernel replaces heatflow_tpu/ops/pallas_cg.py:
_cg_tol_kernel; the PCR factor stacks it consumes are packed once per
transient by :func:`pcr_pack`.

``cg_vmem`` is the fixed-count, unpreconditioned CG on a *baked* operator
(:func:`masked_scaled_operator`): the same phase kernels with sm = 1 and the
stop test off, replacing heatflow_tpu/ops/pallas_cg.py:_cg_kernel. The
multigrid-preconditioned solve that shares this loop is in ``ops/cuda_mg``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from heatflow_tpu_torch.ops.cg import implicit_solve
from heatflow_tpu_torch.ops.linesolve import (line_couplings, pcr_factor,
                                              pcr_fold)
from heatflow_tpu_torch.ops.mgz import coarse_apply, prolong, restrict
from heatflow_tpu_torch.ops.stencil import OFFSETS, apply_stencil, shifted

CHECK_EVERY = 8   # CG iterations enqueued between two host reads of the
                  # device-side stop flag; the iterate and the count do not
                  # depend on it (every phase is a no-op once the flag is set)

MERGED_DEFAULT = False   # the merged-dot recurrence when ``merged=None``;
                         # read at call time, so a caller may set it around
                         # a run to measure the other recurrence

PHASES = ("init", "stencil_dot", "update", "pcr_r", "pcr_z", "finalize",
          "p_update", "finish", "cheb_init", "cheb_step", "merged_w",
          "finalize_merged", "pq_update", "residual", "pcr_row",
          "coarse_res", "prolong", "mg_cheb", "mg_residual", "mg_restrict",
          "mg_prolong")
# phase kernel launches, counted by the C host code where it launches them
_phase_counts = np.zeros(len(PHASES), dtype=np.int64)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _counts_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(_phase_counts.ctypes.data)


def _library():
    """The built kernels' library, checked against this module's mirror of
    the solve-state layout (done flag = int32 word 11 of 8 doubles)."""
    from heatflow_tpu_torch.ops._build import load_library
    lib = load_library()
    if lib.hf_num_phases() != len(PHASES) or lib.hf_cg_state_bytes() > 64:
        raise RuntimeError("csrc/cg_tol.cu and ops/cuda_cg.py disagree on "
                           "the solve-state layout")
    return lib


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def phase_launches() -> dict[str, int]:
    """Launches of each phase kernel since the last :func:`reset_counters`."""
    return {name: int(n) for name, n in zip(PHASES, _phase_counts)}


_FORM_COUNTERS = ("launches", "launches_identity", "launches_rline",
                  "launches_adi", "launches_cheb", "launches_merged",
                  "launches_mgz")


def reset_counters() -> None:
    _phase_counts[:] = 0
    for name in _FORM_COUNTERS:
        setattr(cg_tol, name, 0)
    for name in ("launches_forward", "launches_backward", "launches_jvp"):
        setattr(cg_vmem_solve, name, 0)
    cg_vmem.launches = 0


def pcr_pack(A: torch.Tensor, s: torch.Tensor, free: torch.Tensor,
             axis: int = -1) -> torch.Tensor:
    """Folded line-PCR factor stack (2L+1, Nz, Nr) for :func:`cg_tol`:
    rows 2k/2k+1 are level k's rescaled lower/upper couplings, the last row
    the accumulated diagonal. ``axis=-1`` packs the r-line factors (the
    ``pcr`` operand), ``axis=-2`` the z-line factors (``pcr_z``). Eager
    torch, once per transient."""
    l, u = line_couplings(A, s * free, axis)
    levels2, g = pcr_fold(pcr_factor(l, u, axis=axis), axis=axis)
    return torch.stack([p for lv in levels2 for p in lv] + [g])


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def pcr_stack_apply(stack: torch.Tensor, d: torch.Tensor,
                    axis: int = -1) -> torch.Tensor:
    """Apply a folded PCR stack: L two-plane levels, then the diagonal."""
    levels = (stack.shape[0] - 1) // 2
    s = 1
    for k in range(levels):
        d = (d - stack[2 * k] * shifted(d, -s, axis)
             - stack[2 * k + 1] * shifted(d, s, axis))
        s *= 2
    return stack[2 * levels] * d


def gershgorin_lmax(A, sm):
    """The Gershgorin bound on λmax(sm·A·sm), max_i Σ_j |Â_ij| (sm ≥ 0, so
    the absolute row sums are one |A| apply): a 0-d tensor, no host read."""
    return torch.max(sm * apply_stencil(torch.abs(A), sm))


def cheb_precond_reference(A, sm, degree: int, lmax=None):
    """The degree-``degree`` Chebyshev polynomial preconditioner in sm·A·sm
    with the eigenvalue target [0.08, 1.05]·λmax, in the inputs' dtype."""
    lmax = gershgorin_lmax(A, sm) if lmax is None else lmax
    lo, hi = 0.08 * lmax, 1.05 * lmax
    theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
    sigma = theta / delta

    def pre(r):
        rho = 1.0 / sigma
        d = r / theta
        z = d
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            res = r - sm * apply_stencil(A, sm * z)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
            z = z + d
            rho = rho_new
        return z
    return pre


def mgz_precond_reference(A, sm, pcr, mgz, sweeps: int = 1,
                          omega: float = 0.8, omega_c: float = 0.8):
    """The symmetric two-level V(1,1) cycle of the mgz form: damped r-line
    pre-smooth from zero, fine residual, restriction onto the embedded even
    rows, ``sweeps`` damped line-Jacobi sweeps on the scaled coarse operator
    (the first from zero), prolongation, post-smooth, free mask."""
    free = (sm != 0).to(sm.dtype)
    pcrc, aux = mgz["pcrc"], mgz["aux"]
    apply_op = lambda y: sm * apply_stencil(A, sm * y)

    def pre(r):
        xv = omega * pcr_stack_apply(pcr, r)
        rcs = restrict(aux, r - apply_op(xv))
        yc = omega_c * pcr_stack_apply(pcrc, rcs)
        for _ in range(sweeps - 1):
            yc = yc + omega_c * pcr_stack_apply(
                pcrc, rcs - coarse_apply(mgz["Ac9"], yc))
        xv = prolong(aux, xv, yc)
        xv = xv + omega * pcr_stack_apply(pcr, r - apply_op(xv))
        return xv * free
    return pre


def _precond_reference(A, sm, pcr, pcr_z, cheb_degree=0, mgz=None,
                       mgz_sweeps=1, mgz_omega=0.8, mgz_omega_c=0.8):
    free = (sm != 0).to(sm.dtype)
    if mgz is not None:
        return mgz_precond_reference(A, sm, pcr, mgz, mgz_sweeps, mgz_omega,
                                     mgz_omega_c)
    if pcr_z is not None:
        return lambda r: (pcr_stack_apply(pcr, r, -1)
                          + pcr_stack_apply(pcr_z, r, -2) - r) * free
    if pcr is not None:
        return lambda r: pcr_stack_apply(pcr, r, -1) * free
    if cheb_degree > 0:
        return cheb_precond_reference(A, sm, cheb_degree)
    return lambda r: r


def stencil_dot_reference(A, sm, p):
    """(sm·A·(sm·p), ⟨p, sm·A·(sm·p)⟩) — the plain stencil-and-dot phase."""
    Ap = sm * apply_stencil(A, sm * p)
    return Ap, (p.double() * Ap.double()).sum()


def precond_reference(sm, r, pcr=None, pcr_z=None):
    """(z, ⟨r, z⟩) for the r-line (``pcr``) or ADI (``pcr`` + ``pcr_z``)
    preconditioner — the plain PCR phases."""
    z = _precond_reference(None, sm, pcr, pcr_z)(r)
    return z, (r.double() * z.double()).sum()


def precond_apply_reference(A, sm, r, *, pcr=None, cheb_degree: int = 0,
                            mgz=None, mgz_sweeps: int = 1,
                            mgz_omega: float = 0.8, mgz_omega_c: float = 0.8):
    """(z, ⟨r, z⟩) for the Chebyshev or the mgz preconditioner — the plain
    version of :func:`precond_apply`."""
    z = _precond_reference(A, sm, pcr, None, cheb_degree, mgz, mgz_sweeps,
                           mgz_omega, mgz_omega_c)(r)
    return z, (r.double() * z.double()).sum()


def merged_w_reference(A, sm, u, r):
    """(w = sm·A·(sm·u), δ = ⟨w, u⟩, ⟨r, r⟩, γ = ⟨r, u⟩) — the plain
    merged-dot pass; the sums are float64."""
    w = sm * apply_stencil(A, sm * u)
    d = lambda a, b: (a.double() * b.double()).sum()
    return w, d(w, u), d(r, r), d(r, u)


def _check_forms(pcr, pcr_z, cheb_degree, merged, mgz) -> None:
    """The form checks of the TPU entry point."""
    if pcr is not None and cheb_degree:
        raise ValueError("pcr and cheb_degree are mutually exclusive")
    if pcr_z is not None and pcr is None:
        raise ValueError("pcr_z (ADI) requires the r-line pcr stack too")
    if mgz is not None and pcr is None:
        raise ValueError("mgz (z-semicoarsened MG) uses the r-line pcr "
                         "stack as its smoother — pass pcr too")
    if mgz is not None and (pcr_z is not None or merged):
        raise ValueError("mgz is mutually exclusive with pcr_z/merged")


def _merged_reference(apply_op, precond, r, x, stop2, rr0, maxiter,
                      preconditioned):
    """The Chronopoulos–Gear loop of the TPU kernel on the precomputed
    first residual ``r``: (x, rr, k)."""
    one = torch.ones((), dtype=r.dtype, device=r.device)
    guard = lambda v: torch.where(v != 0, v, one)
    u = precond(r)
    w = apply_op(u)
    gamma = torch.sum(r * u)
    alpha = gamma / guard(torch.sum(w * u))
    p, q = u, w
    rr = rr0
    k = 0
    while k < maxiter and bool(rr > stop2):
        x = x + alpha * p
        r = r - alpha * q
        u = precond(r)
        w = apply_op(u)
        gamma_new = torch.sum(r * u)
        delta = torch.sum(w * u)
        rr = torch.sum(r * r) if preconditioned else gamma_new
        beta = gamma_new / guard(gamma)
        denom = delta - beta * gamma_new / guard(alpha)
        alpha = gamma_new / guard(denom)
        p = u + beta * p
        q = w + beta * q
        gamma = gamma_new
        k += 1
    return x, rr, k


def cg_tol_reference(A, sm, b, x0, rtol, *, maxiter: int = 4000,
                     rtol_wrt: str = "r0", pcr=None, pcr_z=None,
                     cheb_degree: int = 0, merged: bool | None = None,
                     mgz=None, mgz_sweeps: int = 1, mgz_omega: float = 0.8,
                     mgz_omega_c: float = 0.8):
    """Plain PyTorch version of the kernel, in the inputs' dtype: the
    standard PCG recurrence of the TPU kernel (or, with ``merged``, its
    Chronopoulos–Gear recurrence), with its guards (pAp == 0 → 1,
    rz == 0 → 1), its stop rule (while k < maxiter and rr > stop2, rr = ‖r‖²
    when preconditioned and ⟨r, z⟩ otherwise) and x = NaN when rr is not
    finite. Returns (x, iters) with iters a 0-d int32 tensor."""
    _check_rtol_wrt(rtol_wrt)
    if merged is None:
        merged = MERGED_DEFAULT
    _check_forms(pcr, pcr_z, cheb_degree, merged, mgz)
    dtype = b.dtype
    one = torch.ones((), dtype=dtype, device=b.device)
    apply_op = lambda y: sm * apply_stencil(A, sm * y)
    precond = _precond_reference(A, sm, pcr, pcr_z, cheb_degree, mgz,
                                 mgz_sweeps, mgz_omega, mgz_omega_c)
    preconditioned = pcr is not None or cheb_degree > 0
    rtol = torch.as_tensor(rtol, dtype=dtype, device=b.device)

    x = x0
    r = b - apply_op(x)
    rr = torch.sum(r * r)
    ref2 = rr if rtol_wrt == "r0" else torch.sum(b * b)
    stop2 = rtol * rtol * ref2
    if merged:
        x, rr, k = _merged_reference(apply_op, precond, r, x, stop2, rr,
                                     maxiter, preconditioned)
    else:
        z = precond(r)
        p = z
        rz = torch.sum(r * z)
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
            rr = torch.sum(r * r) if preconditioned else rz_new
            k += 1
    x = torch.where(torch.isfinite(rr), x, torch.full_like(x, float("nan")))
    return x, torch.tensor(k, dtype=torch.int32, device=b.device)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

def _check_rtol_wrt(rtol_wrt: str) -> None:
    if rtol_wrt not in ("r0", "b"):
        raise ValueError(f"rtol_wrt must be 'r0' or 'b', got {rtol_wrt!r}")


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {devs}")
    return False


def _require(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stack_levels(stack: torch.Tensor, name: str, nz: int, nr: int,
                  device) -> int:
    if stack.ndim != 3 or stack.shape[0] % 2 != 1:
        raise ValueError(f"{name} must be a (2L+1, Nz, Nr) PCR stack")
    _require(stack, name, (stack.shape[0], nz, nr), device)
    return (stack.shape[0] - 1) // 2


def _check_operator(A, sm, device):
    nz, nr = sm.shape
    if A.ndim != 3 or A.shape[0] not in (7, 9):
        raise ValueError(f"A must be (7|9, Nz, Nr), got {tuple(A.shape)}")
    _require(A, "A", (A.shape[0], nz, nr), device)
    _require(sm, "sm", (nz, nr), device)
    return nz, nr


def _mgz_operands(mgz, sweeps: int, nz: int, nr: int, device):
    """(Ac9 or None, pcrc, aux, coarse levels) after checking the mgz
    operand dict; one sweep needs no coarse operator."""
    if sweeps < 1:
        raise ValueError(f"mgz_sweeps must be >= 1, got {sweeps}")
    pcrc, aux = mgz["pcrc"], mgz["aux"]
    lc = _stack_levels(pcrc, "mgz['pcrc']", nz, nr, device)
    _require(aux, "mgz['aux']", (4, nz, nr), device)
    ac9 = None
    if sweeps > 1:
        ac9 = mgz["Ac9"]
        _require(ac9, "mgz['Ac9']", (9, nz, nr), device)
    return ac9, pcrc, aux, lc


def _mgz_tensors(mgz):
    return () if mgz is None else tuple(mgz[k] for k in ("Ac9", "pcrc", "aux")
                                        if k in mgz)


def cg_tol(A: torch.Tensor, sm: torch.Tensor, b: torch.Tensor,
           x0: torch.Tensor, rtol, *, maxiter: int = 4000,
           rtol_wrt: str = "r0", pcr: torch.Tensor | None = None,
           pcr_z: torch.Tensor | None = None, cheb_degree: int = 0,
           merged: bool | None = None, mgz: dict | None = None,
           mgz_sweeps: int = 1, mgz_omega: float = 0.8,
           mgz_omega_c: float = 0.8):
    """Solve sm·A·sm y = b; returns (x, iters) with iters a 0-d int32
    tensor on the inputs' device. ``rtol`` is a float or a 0-d tensor (read
    on the device, no host sync). ``cheb_degree > 0`` preconditions with the
    Chebyshev polynomial (mutually exclusive with ``pcr``); ``mgz`` (the
    dict of :func:`heatflow_tpu_torch.ops.mgz.mgz_pack` as tensors; needs
    ``pcr``, excludes ``pcr_z`` and ``merged``) with the two-level V-cycle,
    ``mgz_sweeps`` coarse sweeps; ``merged`` (default
    :data:`MERGED_DEFAULT`, read at call time) selects the merged-dot
    recurrence, tolerance-equal to the standard one. CPU tensors take the
    plain version; CUDA float32 tensors take the kernel."""
    _check_rtol_wrt(rtol_wrt)
    if merged is None:
        merged = MERGED_DEFAULT
    cheb_degree = int(cheb_degree)
    _check_forms(pcr, pcr_z, cheb_degree, merged, mgz)
    if _on_cpu(A, sm, b, x0, pcr, pcr_z, *_mgz_tensors(mgz)):
        return cg_tol_reference(A, sm, b, x0, rtol, maxiter=maxiter,
                                rtol_wrt=rtol_wrt, pcr=pcr, pcr_z=pcr_z,
                                cheb_degree=cheb_degree, merged=merged,
                                mgz=mgz, mgz_sweeps=mgz_sweeps,
                                mgz_omega=mgz_omega, mgz_omega_c=mgz_omega_c)
    forms = ["launches", "launches_mgz" if mgz is not None else
             "launches_adi" if pcr_z is not None else
             "launches_rline" if pcr is not None else
             "launches_cheb" if cheb_degree > 0 else "launches_identity"]
    if merged:
        forms.append("launches_merged")
    return _kernel_solve(A, sm, b, x0, rtol, maxiter=maxiter,
                         rtol_wrt=rtol_wrt, pcr=pcr, pcr_z=pcr_z,
                         cheb_degree=cheb_degree, merged=merged, mgz=mgz,
                         mgz_sweeps=mgz_sweeps, mgz_omega=mgz_omega,
                         mgz_omega_c=mgz_omega_c, poison=True,
                         count=(cg_tol, forms))


def _kernel_solve(A, sm, b, x0, rtol, *, maxiter: int, rtol_wrt: str = "r0",
                  pcr=None, pcr_z=None, cheb_degree: int = 0,
                  merged: bool = False, mgz=None, mgz_sweeps: int = 1,
                  mgz_omega: float = 0.8, mgz_omega_c: float = 0.8, mg=None,
                  fixed: bool = False, poison: bool = False,
                  count=None, what: str = "cg_tol"):
    """One solve through the phase kernels of ``csrc/cg_tol.cu`` on CUDA
    float32 tensors: (x, iters). ``mg`` (a function of the z plane that
    returns the multigrid descriptor, see ``ops/cuda_mg``) selects the
    V-cycle preconditioner; ``fixed`` runs ``maxiter`` iterations with the
    stop test off and never reads the device; ``poison`` makes x NaN when
    the residual is not finite (``cg_tol``'s contract); ``count`` (a
    wrapper function and the names of its launch counts) is counted where
    the solve is launched."""
    lib = _library()
    dev = b.device
    nz, nr = _check_operator(A, sm, dev)
    _require(b, "b", (nz, nr), dev)
    _require(x0, "x0", (nz, nr), dev)
    lr = 0 if pcr is None else _stack_levels(pcr, "pcr", nz, nr, dev)
    lz = 0 if pcr_z is None else _stack_levels(pcr_z, "pcr_z", nz, nr, dev)
    ac9 = pcrc = aux = None
    lc = 0
    if mgz is not None:
        ac9, pcrc, aux, lc = _mgz_operands(mgz, int(mgz_sweeps), nz, nr, dev)
    lmax = None
    if cheb_degree > 0:
        lmax = gershgorin_lmax(A, sm).reshape(1).contiguous()
    rtol_t = torch.as_tensor(rtol, dtype=torch.float32, device=dev)
    if rtol_t.numel() != 1:
        raise ValueError("rtol must be a scalar")
    rtol_t = rtol_t.reshape(()).contiguous()

    x = torch.empty_like(b)
    vecs = torch.empty((4, nz, nr), dtype=torch.float32, device=dev)
    r, z, p, Ap = vecs.unbind(0)
    if pcr is None and cheb_degree == 0 and mg is None:
        z = r                         # identity form: z aliases r
    n_extra = lib.hf_cg_extra_planes(cheb_degree, int(merged),
                                     int(mgz is not None))
    extra = (torch.empty((n_extra, nz, nr), dtype=torch.float32, device=dev)
             if n_extra else None)
    nparts = lib.hf_cg_nparts(nz, nr)
    parts = torch.empty((4, nparts), dtype=torch.float64, device=dev)
    state = torch.empty(8, dtype=torch.float64, device=dev)
    stream = _stream()
    desc = None if mg is None else mg(z)
    args = (_ptr(A), A.shape[0], _ptr(sm), _ptr(b), _ptr(x0), _ptr(rtol_t),
            _ptr(pcr), lr, _ptr(pcr_z), lz, _ptr(x), _ptr(r), _ptr(z),
            _ptr(p), _ptr(Ap), _ptr(parts), nparts, _ptr(state), nz, nr,
            int(maxiter), int(rtol_wrt == "r0"), _counts_ptr(), stream,
            _ptr(lmax), cheb_degree, int(merged), _ptr(ac9), _ptr(pcrc), lc,
            _ptr(aux), int(mgz_sweeps), float(mgz_omega), float(mgz_omega_c),
            _ptr(extra), None if desc is None else ctypes.addressof(desc),
            int(fixed))

    if count is not None:
        fn, names = count
        for name in names:
            setattr(fn, name, getattr(fn, name) + 1)
    _check(lib.hf_cg_tol_start(*args), f"{what} start")
    ints = state.view(torch.int32)
    if fixed:
        _check(lib.hf_cg_tol_iterate(*args, int(maxiter)), f"{what} iterate")
    else:
        launched = 0
        while launched < maxiter:
            n = min(CHECK_EVERY, maxiter - launched)
            _check(lib.hf_cg_tol_iterate(*args, n), f"{what} iterate")
            launched += n
            if ints[11].item():
                break
    if not poison:
        return x, ints[10].clone()
    iters = torch.empty((), dtype=torch.int32, device=dev)
    _check(lib.hf_cg_tol_finish(_ptr(x), _ptr(iters), _ptr(state), nz * nr,
                                _counts_ptr(), stream), f"{what} finish")
    return x, iters


for _name in _FORM_COUNTERS:
    setattr(cg_tol, _name, 0)


def masked_scaled_operator(A: torch.Tensor, free: torch.Tensor):
    """The baked operator of :func:`cg_vmem`: symmetric Jacobi scaling and
    exact Dirichlet row/column elimination written into the coefficients.

    Returns (C, s) with C the scaled and masked stencil (identity rows at
    constrained nodes) and s the scaling vector; solve C y = s·(b − A g),
    then u = s·y·free + g. Leading batch dimensions of ``A`` (..., 7, Nz, Nr)
    and ``free`` carry through."""
    diag = A[..., 0, :, :]
    s = torch.rsqrt(torch.where(diag > 0, diag, torch.ones_like(diag))) \
        * free + (1.0 - free)
    sf = s * free
    C = A * sf[..., None, :, :]
    parts = [C[..., 0, :, :] * s * free + (1.0 - free)]
    for k, (di, dj) in enumerate(OFFSETS[1:], start=1):
        parts.append(C[..., k, :, :] * shifted(shifted(sf, di, -2), dj, -1))
    return torch.stack(parts, dim=-3), s


def cg_vmem_reference(C, b, x0, *, iters: int = 64):
    """Plain PyTorch version of :func:`cg_vmem`, in the inputs' dtype: the
    standard recurrence with A p recomputed, the guards pAp == 0 → 1 and
    rz == 0 → 1, no stop test."""
    one = torch.ones((), dtype=b.dtype, device=b.device)
    x = x0
    r = b - apply_stencil(C, x)
    p = r
    rz = torch.sum(r * r)
    for _ in range(iters):
        Ap = apply_stencil(C, p)
        pAp = torch.sum(p * Ap)
        alpha = rz / torch.where(pAp != 0, pAp, one)
        x = x + alpha * p
        r = r - alpha * Ap
        rz_new = torch.sum(r * r)
        beta = rz_new / torch.where(rz != 0, rz, one)
        p = r + beta * p
        rz = rz_new
    return x


def cg_vmem(C: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, *,
            iters: int = 64) -> torch.Tensor:
    """Solve C x = b with ``iters`` unpreconditioned CG iterations.

    C: (7|9, Nz, Nr) scaled and masked stencil
    (:func:`masked_scaled_operator`); b, x0: (Nz, Nr). CPU tensors take the
    plain version; CUDA float32 tensors the phase kernels of ``cg_tol`` with
    sm = 1, the identity preconditioner and the stop test off: the count is
    fixed, so every iteration is enqueued at once and the host reads nothing
    during the solve."""
    if _on_cpu(C, b, x0):
        return cg_vmem_reference(C, b, x0, iters=iters)
    x, _ = _kernel_solve(C, torch.ones_like(b), b, x0, 0.0,
                         maxiter=int(iters), fixed=True,
                         count=(cg_vmem, ["launches"]), what="cg_vmem")
    return x


cg_vmem.launches = 0


def precond_apply(A: torch.Tensor, sm: torch.Tensor, r: torch.Tensor, *,
                  pcr: torch.Tensor | None = None, cheb_degree: int = 0,
                  mgz: dict | None = None, mgz_sweeps: int = 1,
                  mgz_omega: float = 0.8, mgz_omega_c: float = 0.8):
    """The kernel's Chebyshev or mgz preconditioner alone: (z = M⁻¹r,
    ⟨r, z⟩ float64) through the phase kernels the solve launches."""
    if (cheb_degree > 0) == (mgz is not None):
        raise ValueError("give cheb_degree or mgz (with pcr), not both")
    _check_forms(pcr, None, cheb_degree, False, mgz)
    if _on_cpu(A, sm, r, pcr, *_mgz_tensors(mgz)):
        return precond_apply_reference(
            A, sm, r, pcr=pcr, cheb_degree=cheb_degree, mgz=mgz,
            mgz_sweeps=mgz_sweeps, mgz_omega=mgz_omega,
            mgz_omega_c=mgz_omega_c)
    lib = _library()
    dev = r.device
    nz, nr = _check_operator(A, sm, dev)
    _require(r, "r", (nz, nr), dev)
    lr = 0 if pcr is None else _stack_levels(pcr, "pcr", nz, nr, dev)
    ac9 = pcrc = aux = lmax = None
    lc = 0
    if mgz is not None:
        ac9, pcrc, aux, lc = _mgz_operands(mgz, int(mgz_sweeps), nz, nr, dev)
    else:
        lmax = gershgorin_lmax(A, sm).reshape(1).contiguous()
    z = torch.empty_like(r)
    extra = torch.empty((lib.hf_cg_extra_planes(cheb_degree, 0,
                                                int(mgz is not None)), nz,
                         nr), dtype=torch.float32, device=dev)
    nparts = lib.hf_cg_nparts(nz, nr)
    parts = torch.zeros((4, nparts), dtype=torch.float64, device=dev)
    which = ctypes.c_int(0)
    _check(lib.hf_precond_apply(
        _ptr(A), A.shape[0], _ptr(sm), _ptr(r), _ptr(pcr), lr, _ptr(z),
        _ptr(parts), nparts, nz, nr, _counts_ptr(), _stream(), _ptr(lmax),
        int(cheb_degree), _ptr(ac9), _ptr(pcrc), lc, _ptr(aux),
        int(mgz_sweeps), float(mgz_omega), float(mgz_omega_c), _ptr(extra),
        ctypes.addressof(which)), "precond_apply")
    n_rz = nz if mgz is not None else (nz * nr + 255) // 256
    return (extra[1] if which.value else z), parts[2, :n_rz].sum()


def merged_w(A: torch.Tensor, sm: torch.Tensor, u: torch.Tensor,
             r: torch.Tensor):
    """The merged-dot pass alone: (w = sm·A·(sm·u), δ = ⟨w, u⟩, ⟨r, r⟩,
    γ = ⟨r, u⟩), the sums float64 0-d tensors."""
    if _on_cpu(A, sm, u, r):
        return merged_w_reference(A, sm, u, r)
    lib = _library()
    nz, nr = _check_operator(A, sm, u.device)
    _require(u, "u", (nz, nr), u.device)
    _require(r, "r", (nz, nr), u.device)
    w = torch.empty_like(u)
    nparts = lib.hf_cg_nparts(nz, nr)
    parts = torch.empty((3, nparts), dtype=torch.float64, device=u.device)
    _check(lib.hf_merged_w(_ptr(A), A.shape[0], _ptr(sm), _ptr(u), _ptr(r),
                           _ptr(w), _ptr(parts), nparts, nz, nr,
                           _counts_ptr(), _stream()), "merged_w")
    delta, rr, gamma = parts[:, :(nz * nr + 255) // 256].sum(dim=1)
    return w, delta, rr, gamma


def _state(device, **fields) -> torch.Tensor:
    """A solve-state record (8 float64 words: rz, rr, stop2, alpha, beta,
    then the int32 count and done flag in words 10 and 11 of its int32
    view); fields not given are 0."""
    st = torch.zeros(8, dtype=torch.float64, device=device)
    for i, name in enumerate(("rz", "rr", "stop2", "alpha", "beta")):
        if name in fields:
            st[i] = float(fields[name])
    ints = st.view(torch.int32)
    ints[10] = int(fields.get("k", 0))
    ints[11] = int(fields.get("done", 0))
    return st


def pq_update_reference(p, q, u, w, beta):
    """(u + β·p, w + β·q), β rounded to the fields' dtype."""
    beta = torch.as_tensor(beta, dtype=torch.float64).to(p.dtype).to(p.device)
    return u + beta * p, w + beta * q


def pq_update(p, q, u, w, beta):
    """The merged recurrence's direction phase alone: (u + β·p, w + β·q);
    the inputs are left as they are."""
    if _on_cpu(p, q, u, w):
        return pq_update_reference(p, q, u, w, beta)
    lib = _library()
    for name, t in (("p", p), ("q", q), ("u", u), ("w", w)):
        _require(t, name, tuple(p.shape), p.device)
    p_n, q_n = p.clone(), q.clone()
    st = _state(p.device, beta=beta)
    _check(lib.hf_pq_update(_ptr(p_n), _ptr(q_n), _ptr(u), _ptr(w), _ptr(st),
                            p.numel(), _counts_ptr(), _stream()),
           "pq_update")
    return p_n, q_n


def finalize_merged_reference(state: dict, delta, rr, gamma, bb=0.0, *,
                              first: bool, preconditioned: bool, rtol=0.0,
                              maxiter: int = 4000, rtol_wrt: str = "r0"):
    """The merged recurrence's scalar phase in Python floats on a state
    dict (rz = γ, rr, stop2, alpha, beta, k, done); returns the new dict."""
    g = lambda v: v if v != 0 else 1.0
    delta, rr, gamma, bb = (float(v) for v in (delta, rr, gamma, bb))
    st = dict(state)
    if first:
        rt = float(np.float32(rtol))
        st.update(rz=gamma, rr=rr,
                  stop2=rt * rt * (rr if rtol_wrt == "r0" else bb),
                  alpha=gamma / g(delta), beta=0.0, k=0)
    else:
        if st.get("done"):
            return st
        beta = gamma / g(st["rz"])
        denom = delta - beta * gamma / g(st["alpha"])
        st.update(alpha=gamma / g(denom), beta=beta, rz=gamma,
                  rr=rr if preconditioned else gamma, k=st["k"] + 1)
    st["done"] = int(not (st["k"] < maxiter and st["rr"] > st["stop2"]))
    return st


def finalize_merged(state: dict, delta, rr, gamma, bb=0.0, *, first: bool,
                    preconditioned: bool, rtol=0.0, maxiter: int = 4000,
                    rtol_wrt: str = "r0", device="cuda"):
    """The merged recurrence's scalar phase alone, through its kernel on
    ``device`` (the plain version for ``device='cpu'``): the sums go in as
    one-entry partial-sum planes."""
    device = torch.device(device)
    if device.type == "cpu":
        return finalize_merged_reference(
            state, delta, rr, gamma, bb, first=first,
            preconditioned=preconditioned, rtol=rtol, maxiter=maxiter,
            rtol_wrt=rtol_wrt)
    lib = _library()
    st = _state(device, **state)
    parts = torch.tensor([[float(delta)], [float(rr)], [float(gamma)],
                          [float(bb)]], dtype=torch.float64, device=device)
    rtol_t = torch.tensor(float(rtol), dtype=torch.float32, device=device)
    _check(lib.hf_finalize_merged(_ptr(st), _ptr(parts), 1, 1,
                                  int(preconditioned), int(first),
                                  _ptr(rtol_t), int(maxiter),
                                  int(rtol_wrt == "r0"), _counts_ptr(),
                                  _stream()), "finalize_merged")
    host = st.cpu()
    ints = host.view(torch.int32)
    out = {name: float(host[i]) for i, name in
           enumerate(("rz", "rr", "stop2", "alpha", "beta"))}
    out.update(k=int(ints[10]), done=int(ints[11]))
    return out


def mgz_residual(A, sm, r, v):
    """The mgz cycle's fine residual alone: r − sm·A·(sm·v)."""
    if _on_cpu(A, sm, r, v):
        return r - sm * apply_stencil(A, sm * v)
    lib = _library()
    nz, nr = _check_operator(A, sm, r.device)
    _require(r, "r", (nz, nr), r.device)
    _require(v, "v", (nz, nr), r.device)
    out = torch.empty_like(r)
    _check(lib.hf_residual(_ptr(A), A.shape[0], _ptr(sm), _ptr(r), _ptr(v),
                           _ptr(out), nz, nr, _counts_ptr(), _stream()),
           "residual")
    return out


def mgz_pcr_row_reference(src, F, scale, *, aux=None, acc=None, sm=None,
                          dot=None):
    """Plain version of :func:`mgz_pcr_row`."""
    d = src if aux is None else restrict(aux, src)
    out = scale * pcr_stack_apply(F, d)
    if acc is not None:
        out = acc + out
    if sm is not None:
        out = out * (sm != 0).to(out.dtype)
    dsum = None if dot is None else (dot.double() * out.double()).sum()
    return out, (None if aux is None else d), dsum


def mgz_pcr_row(src, F, scale: float, *, aux=None, acc=None, sm=None,
                dot=None):
    """The mgz cycle's row kernel alone: out = (acc + scale·PCR_F(d))·free
    with d = src, or the scaled restriction of src when ``aux`` is given;
    ``acc``, ``sm`` (the mask) and ``dot`` are optional. Returns (out, d or
    None, ⟨dot, out⟩ float64 or None)."""
    if _on_cpu(src, F, aux, acc, sm, dot):
        return mgz_pcr_row_reference(src, F, scale, aux=aux, acc=acc, sm=sm,
                                     dot=dot)
    lib = _library()
    dev = src.device
    nz, nr = src.shape
    _require(src, "src", (nz, nr), dev)
    levels = _stack_levels(F, "F", nz, nr, dev)
    for name, t in (("acc", acc), ("sm", sm), ("dot", dot)):
        if t is not None:
            _require(t, name, (nz, nr), dev)
    store = None
    if aux is not None:
        _require(aux, "aux", (4, nz, nr), dev)
        store = torch.empty_like(src)
    out = torch.empty_like(src)
    part = torch.zeros(lib.hf_cg_nparts(nz, nr), dtype=torch.float64,
                       device=dev)
    _check(lib.hf_pcr_row(_ptr(src), _ptr(aux), _ptr(store), _ptr(F), levels,
                          float(scale), _ptr(acc), _ptr(sm), _ptr(out),
                          _ptr(dot), _ptr(part), nz, nr, _counts_ptr(),
                          _stream()), "pcr_row")
    return out, store, (None if dot is None else part[:nz].sum())


def mgz_coarse_res(Ac9, rcs, y):
    """The embedded coarse residual alone: rcs − Ac9·y."""
    if _on_cpu(Ac9, rcs, y):
        return rcs - coarse_apply(Ac9, y)
    lib = _library()
    nz, nr = rcs.shape
    _require(Ac9, "Ac9", (9, nz, nr), rcs.device)
    _require(rcs, "rcs", (nz, nr), rcs.device)
    _require(y, "y", (nz, nr), rcs.device)
    out = torch.empty_like(rcs)
    _check(lib.hf_coarse_res(_ptr(Ac9), _ptr(rcs), _ptr(y), _ptr(out), nz, nr,
                             _counts_ptr(), _stream()), "coarse_res")
    return out


def mgz_prolong(aux, x, yc):
    """The prolongation alone: x + P(sc·yc); x is left as it is."""
    if _on_cpu(aux, x, yc):
        return prolong(aux, x, yc)
    lib = _library()
    nz, nr = x.shape
    _require(aux, "aux", (4, nz, nr), x.device)
    _require(x, "x", (nz, nr), x.device)
    _require(yc, "yc", (nz, nr), x.device)
    out = x.clone()
    _check(lib.hf_prolong(_ptr(out), _ptr(yc), _ptr(aux), nz, nr,
                          _counts_ptr(), _stream()), "prolong")
    return out


def stencil_dot(A: torch.Tensor, sm: torch.Tensor, p: torch.Tensor):
    """The kernel's stencil-and-dot phase alone: (Ap, ⟨p, Ap⟩) with
    Ap = sm·A·(sm·p); ⟨p, Ap⟩ is a float64 0-d tensor."""
    if _on_cpu(A, sm, p):
        return stencil_dot_reference(A, sm, p)
    lib = _library()
    nz, nr = _check_operator(A, sm, p.device)
    _require(p, "p", (nz, nr), p.device)
    Ap = torch.empty_like(p)
    blocks = lib.hf_cg_nparts(nz, nr)
    part = torch.empty(blocks, dtype=torch.float64, device=p.device)
    _check(lib.hf_stencil_dot(_ptr(A), A.shape[0], _ptr(sm), _ptr(p),
                              _ptr(Ap), _ptr(part), nz, nr, _counts_ptr(),
                              _stream()), "stencil_dot")
    used = (nz * nr + 255) // 256
    return Ap, part[:used].sum()


def precond(sm: torch.Tensor, r: torch.Tensor, pcr: torch.Tensor,
            pcr_z: torch.Tensor | None = None):
    """The kernel's PCR phases alone: (z, ⟨r, z⟩) with z the r-line
    (``pcr``) or ADI (``pcr`` + ``pcr_z``) preconditioned residual;
    ⟨r, z⟩ is a float64 0-d tensor."""
    if _on_cpu(sm, r, pcr, pcr_z):
        return precond_reference(sm, r, pcr, pcr_z)
    lib = _library()
    dev = r.device
    nz, nr = sm.shape
    _require(sm, "sm", (nz, nr), dev)
    _require(r, "r", (nz, nr), dev)
    lr = _stack_levels(pcr, "pcr", nz, nr, dev)
    z = torch.empty_like(r)
    part = torch.empty(lib.hf_cg_nparts(nz, nr), dtype=torch.float64,
                       device=dev)
    stream = _stream()
    _check(lib.hf_pcr_r(_ptr(r), _ptr(sm), _ptr(pcr), lr, _ptr(z),
                        _ptr(part), nz, nr, _counts_ptr(), stream), "pcr_r")
    if pcr_z is None:
        return z, part[:nz].sum()
    lz = _stack_levels(pcr_z, "pcr_z", nz, nr, dev)
    _check(lib.hf_pcr_z(_ptr(r), _ptr(sm), _ptr(pcr_z), lz, _ptr(z),
                        _ptr(part), nz, nr, _counts_ptr(), stream), "pcr_z")
    return z, part[:(nr + 15) // 16].sum()


def _implicit_cg(solver, A, sm, b, x0, rtol, maxiter, rtol_wrt, pcr, pcr_z,
                 count: bool) -> torch.Tensor:
    """The implicitly differentiated solve of sm·A·sm y = b, each solve by
    ``solver`` (:func:`cg_tol` or its plain version)."""
    def solve(rhs, direction, A, sm, b, x0, pcr, pcr_z):
        if rhs.ndim == 3:     # a batch of right-hand sides (torch.func.vmap)
            return torch.stack([solve(v, direction, A, sm, b, x0, pcr,
                                      pcr_z) for v in rhs])
        bb = torch.sum(b * b)
        c = torch.sum(rhs * b) / torch.where(bb > 0, bb, torch.ones_like(bb))
        x, _ = solver(A, sm, rhs.contiguous(), (c * x0).contiguous(), rtol,
                      maxiter=maxiter, rtol_wrt=rtol_wrt, pcr=pcr,
                      pcr_z=pcr_z)
        if count:
            name = f"launches_{direction}"
            setattr(cg_vmem_solve, name, getattr(cg_vmem_solve, name) + 1)
        return x

    operands = tuple(None if t is None else t.detach()
                     for t in (A, sm, b, x0, pcr, pcr_z))
    return implicit_solve(solve, b,
                          lambda x: b - sm * apply_stencil(A, sm * x),
                          operands)


def cg_vmem_solve(A: torch.Tensor, sm: torch.Tensor, b: torch.Tensor,
                  x0: torch.Tensor, rtol, *, maxiter: int = 4000,
                  rtol_wrt: str = "r0", pcr: torch.Tensor | None = None,
                  pcr_z: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable :func:`cg_tol`: solves sm·A·sm y = b by implicit
    differentiation (replaces heatflow_tpu/ops/pallas_cg.py:cg_vmem_solve).
    Gradients and tangents flow to ``A``, ``sm`` and ``b`` (not to ``x0``);
    the ``pcr``/``pcr_z`` stacks only steer the solves and are detached.
    The forward pass, each backward pass and each forward-mode tangent is
    one ``cg_tol`` solve: the kernel on CUDA float32 tensors (counted in
    ``cg_vmem_solve.launches_forward``, ``.launches_backward`` and
    ``.launches_jvp``), the plain version on CPU tensors. Every solve is
    seeded with c·x0, c = ⟨rhs, b⟩/⟨b, b⟩ (1 for the primal solve; see
    :func:`heatflow_tpu_torch.ops.cg.pcg_solve`)."""
    return _implicit_cg(cg_tol, A, sm, b, x0, rtol, maxiter, rtol_wrt, pcr,
                        pcr_z, count=not _on_cpu(A, sm, b, x0, pcr, pcr_z))


def cg_vmem_solve_reference(A, sm, b, x0, rtol, *, maxiter: int = 4000,
                            rtol_wrt: str = "r0", pcr=None, pcr_z=None):
    """Plain version of :func:`cg_vmem_solve`, on any device: the same
    implicit differentiation with every solve by :func:`cg_tol_reference`."""
    return _implicit_cg(cg_tol_reference, A, sm, b, x0, rtol, maxiter,
                        rtol_wrt, pcr, pcr_z, count=False)


cg_vmem_solve.launches_forward = 0
cg_vmem_solve.launches_backward = 0
cg_vmem_solve.launches_jvp = 0
