"""Tolerance-stopped PCG on the scaled stencil operator: the CUDA kernel
(``csrc/cg_tol.cu``) and its plain PyTorch version.

``cg_tol`` solves sm·A·sm y = b, with b and x0 vanishing at constrained
dofs and sm = rsqrt(diag(A))·free, preconditioned by nothing, by the r-line
block-Jacobi solve (``pcr``: each line's exact tridiagonal solve from its
Thomas factors), by the split-additive ADI solve R r + Z r − r (``pcr`` and
the z-line Thomas factors ``pcr_z``), by a fixed Chebyshev polynomial in
the operator (``cheb_degree``) or by the z-semicoarsened two-level V-cycle
over the r-line smoother (``mgz``, operands from ``ops/mgz.py``), with the
standard recurrence or the Chronopoulos–Gear merged-dot one (``merged``),
stopping on the true residual
‖r‖ ≤ rtol·‖r0‖ (``rtol_wrt='r0'``) or rtol·‖b‖ (``'b'``). With ``cols``
(the ELL form, preconditioned by nothing) the operator is an ELL gather
(``ops/ell.py``) on a mesh's nodes as a 1 × N grid: A the (N, K) values,
``cols`` the int32 column ids. A tensor on the
CPU goes to :func:`cg_tol_reference`; a CUDA tensor goes to the kernel, or
the call raises. The kernel replaces heatflow_tpu/ops/pallas_cg.py:
_cg_tol_kernel; the line factors it consumes are packed once per operand
set by :func:`rline_pack` and :func:`zline_pack` (a kernel each on the
card). The mgz cycle runs as fused passes
(:func:`mgz_pre`, :func:`mgz_coarse`, :func:`mgz_coarse_res`,
:func:`mgz_prolong_res`, :func:`mgz_post`, each with its plain version, and
:func:`mgz_cycle_reference` composed from them).

``cg_vmem`` is the fixed-count, unpreconditioned CG on a *baked* operator
(:func:`masked_scaled_operator`): the same phase kernels with sm = 1 and the
stop test off, replacing heatflow_tpu/ops/pallas_cg.py:_cg_kernel. The
multigrid-preconditioned solve that shares this loop is in ``ops/cuda_mg``.
"""

from __future__ import annotations

import ctypes
import time
from collections import OrderedDict

import numpy as np
import torch

from heatflow_tpu_torch.ops.cg import implicit_solve
from heatflow_tpu_torch.ops.ell import operator_product
from heatflow_tpu_torch.ops.linesolve import (line_couplings, pcr_factor,
                                              pcr_fold, thomas_apply_lines,
                                              thomas_factor_lines)
from heatflow_tpu_torch.ops.mgz import coarse_apply, prolong, restrict
from heatflow_tpu_torch.ops.stencil import OFFSETS, apply_stencil, shifted
from heatflow_tpu_torch.utils import span

CHECK_EVERY = 8   # CG iterations in one block of the solve's graph; the
                  # device tests the stop flag between blocks (a conditional
                  # graph node), the host not at all; the iterate and the
                  # count do not depend on it (every phase is a no-op once
                  # the flag is set); even, since an iteration's slot in the
                  # block picks its plane of p (the capture refuses odd)
GRAPHS_KEPT = 4   # captured graphs a workspace keeps (the last used)

MERGED_DEFAULT = False   # the merged-dot recurrence when ``merged=None``;
                         # read at call time, so a caller may set it around
                         # a run to measure the other recurrence

PHASES = ("init", "stencil_dot", "update", "pcr_r", "pcr_z", "finalize",
          "p_update", "finish", "cheb_init", "cheb_step", "merged_w",
          "finalize_merged", "pq_update", "mgz_pre", "mgz_coarse",
          "mgz_coarse_res", "mgz_prolong_res", "mgz_post", "mg_cheb",
          "mg_cheb_update", "mg_cheb_pre", "mg_restrict_res",
          "mg_prolong_cheb", "mg_last", "update_pcr_r")
# phase kernel launches: counted by the C host code where it launches a
# phase alone, and for a solve's graph where the graph is launched (start
# and finish) and by the device where it runs a block of iterations
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
    """Launches of each phase kernel since the last :func:`reset_counters`
    (reads the devices' block-run counters: a host sync)."""
    counts = _phase_counts.copy()
    for ws in _workspaces.values():
        for g in ws.graphs.values():
            counts += int(g.runs.item()) * g.counts_body
    return {name: int(n) for name, n in zip(PHASES, counts)}


def graph_stats() -> dict[str, dict]:
    """For each solve form with a captured graph: the kernel launches of
    one iteration, as the graph's loop body holds them (``CHECK_EVERY``
    iterations a body), the graphs kept and the host seconds the last
    capture and instantiation took; a solve form recorded into a
    transient's graph (``ops/cuda_step``) as its latest capture holds it."""
    stats = lambda g, kept: dict(
        launches_per_iteration=float(g.counts_body.sum()) / CHECK_EVERY,
        graphs=kept, capture_s=g.capture_s)
    out = {ws.form_name: stats(g, len(ws.graphs))
           for ws in _workspaces.values() for g in ws.graphs.values()}
    out.update({name: stats(g, 1) for name, g in _recorded.items()})
    return out


def launches_per_iteration() -> dict[str, float]:
    """Phase-kernel launches a CG iteration, by solve form (the workspace's
    name: 'rline', 'adi', 'mgz', 'mg', ...), over the loop bodies the
    device ran since the last :func:`reset_counters`: each body run is
    ``CHECK_EVERY`` iterations (a host sync)."""
    out = {form: list(acc) for form, acc in _recorded_runs.items()}
    for ws in _workspaces.values():
        for g in ws.graphs.values():
            runs = int(g.runs.item())
            if runs:
                acc = out.setdefault(ws.form_name, [0, 0])
                acc[0] += runs * int(g.counts_body.sum())
                acc[1] += runs * CHECK_EVERY
    return {form: n / its for form, (n, its) in out.items()}


_FORM_COUNTERS = ("launches", "launches_identity", "launches_rline",
                  "launches_adi", "launches_cheb", "launches_merged",
                  "launches_mgz", "launches_ell")


def reset_counters() -> None:
    _phase_counts[:] = 0
    _recorded_runs.clear()
    for ws in _workspaces.values():
        for g in ws.graphs.values():
            g.runs.zero_()
    for name in _FORM_COUNTERS:
        setattr(cg_tol, name, 0)
    for name in ("launches_forward", "launches_backward", "launches_jvp"):
        setattr(cg_vmem_solve, name, 0)
    cg_vmem.launches = 0
    rline_pack.launches = 0
    zline_pack.launches = 0


def pcr_pack(A: torch.Tensor, s: torch.Tensor, free: torch.Tensor,
             axis: int = -1) -> torch.Tensor:
    """Folded line-PCR factor stack (2L+1, Nz, Nr): rows 2k/2k+1 are level
    k's rescaled lower/upper couplings, the last row the accumulated
    diagonal: the JAX package's kernel operand, applied by
    :func:`pcr_stack_apply`. ``cg_tol`` takes the Thomas factors of
    :func:`rline_pack` and :func:`zline_pack` instead. Eager torch."""
    l, u = line_couplings(A, s * free, axis)
    levels2, g = pcr_fold(pcr_factor(l, u, axis=axis), axis=axis)
    return torch.stack([p for lv in levels2 for p in lv] + [g])


def rline_pack_reference(A, s, free) -> torch.Tensor:
    """Plain version of :func:`rline_pack`, on any device: the couplings of
    (s·free)·A·(s·free) along r and their Thomas factors
    (:func:`~heatflow_tpu_torch.ops.linesolve.thomas_factor_lines`)."""
    l, u = line_couplings(A, s * free, -1)
    return thomas_factor_lines(l, u)


def zline_pack_reference(A, s, free) -> torch.Tensor:
    """Plain version of :func:`zline_pack`, on any device: the couplings of
    (s·free)·A·(s·free) along z and their Thomas factors down each
    column."""
    l, u = line_couplings(A, s * free, -2)
    return thomas_factor_lines(l, u, axis=-2)


def rline_pack(A: torch.Tensor, s: torch.Tensor,
               free: torch.Tensor) -> torch.Tensor:
    """The r-line operand of :func:`cg_tol` (``pcr``): the (3, Nz, Nr)
    Thomas factors of every grid row's line-tridiagonal system, once per
    operand set. CPU tensors take the plain version; CUDA float32 tensors
    the factor kernel (one launch, counted in ``rline_pack.launches``)."""
    if _on_cpu(A, s, free):
        return rline_pack_reference(A, s, free)
    return _line_pack(A, s, free, -1)


def zline_pack(A: torch.Tensor, s: torch.Tensor,
               free: torch.Tensor) -> torch.Tensor:
    """The z-line operand of :func:`cg_tol` (``pcr_z``, the ADI form): the
    (3, Nz, Nr) Thomas factors of every grid column's line-tridiagonal
    system, once per operand set. CPU tensors take the plain version; CUDA
    float32 tensors the factor kernel (one launch, counted in
    ``zline_pack.launches``)."""
    if _on_cpu(A, s, free):
        return zline_pack_reference(A, s, free)
    return _line_pack(A, s, free, -2)


rline_pack.launches = 0
zline_pack.launches = 0


def _line_pack(A, s, free, axis: int) -> torch.Tensor:
    if A.ndim != 3 or A.shape[0] not in (7, 9):
        raise ValueError(f"A must be (7|9, Nz, Nr), got {tuple(A.shape)}")
    return _LineFactor.apply(A.contiguous(), s.contiguous(),
                             free.contiguous(), axis)


def _line_factor_launch(A, s, free, axis: int) -> torch.Tensor:
    dev = s.device
    nz, nr = s.shape
    _require(A, "A", (A.shape[0], nz, nr), dev)
    _require(s, "s", (nz, nr), dev)
    _require(free, "free", (nz, nr), dev)
    F = torch.empty((3, nz, nr), dtype=torch.float32, device=dev)
    wrapper, launch = ((rline_pack, _library().hf_rline_factor) if axis == -1
                       else (zline_pack, _library().hf_zline_factor))
    _check(launch(_ptr(A), _ptr(s), _ptr(free), _ptr(F), nz, nr, _stream()),
           wrapper.__name__)
    wrapper.launches += 1
    return F


class _LineFactor(torch.autograd.Function):
    """A factor kernel's launch as a Function, so that under torch.func's
    transforms (the fit's jvp, vmapped over its tangents) the operator
    comes in as plain tensors whose pointers the kernel takes; the factors
    only steer the solves and are never differentiated."""

    @staticmethod
    def forward(A, s, free, axis):
        return _line_factor_launch(A, s, free, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, A, s, free, axis):
        if any(d is not None for d in in_dims):
            raise NotImplementedError("a batch of operators under vmap")
        return _line_factor_launch(A, s, free, axis), None


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
        xv = omega * thomas_apply_lines(pcr, r)
        rcs = restrict(aux, r - apply_op(xv))
        yc = omega_c * thomas_apply_lines(pcrc, rcs)
        for _ in range(sweeps - 1):
            yc = yc + omega_c * thomas_apply_lines(
                pcrc, rcs - coarse_apply(mgz["Ac9"], yc))
        xv = prolong(aux, xv, yc)
        xv = xv + omega * thomas_apply_lines(pcr, r - apply_op(xv))
        return xv * free
    return pre


def _precond_reference(A, sm, pcr, pcr_z, cheb_degree=0, mgz=None,
                       mgz_sweeps=1, mgz_omega=0.8, mgz_omega_c=0.8):
    free = (sm != 0).to(sm.dtype)
    if mgz is not None:
        return mgz_precond_reference(A, sm, pcr, mgz, mgz_sweeps, mgz_omega,
                                     mgz_omega_c)
    if pcr_z is not None:
        return lambda r: (thomas_apply_lines(pcr, r)
                          + thomas_apply_lines(pcr_z, r, axis=-2) - r) * free
    if pcr is not None:
        return lambda r: thomas_apply_lines(pcr, r) * free
    if cheb_degree > 0:
        return cheb_precond_reference(A, sm, cheb_degree)
    return lambda r: r


def stencil_dot_reference(A, sm, p, cols=None):
    """(sm·A·(sm·p), ⟨p, sm·A·(sm·p)⟩) — the plain stencil-and-dot phase
    (with ``cols``, the ELL form's: the gather of ``ops/ell.py``)."""
    Ap = sm * operator_product(cols)(A, sm * p)
    return Ap, (p.double() * Ap.double()).sum()


def stencil_dot_p_reference(A, sm, z, p, beta, first: bool, cols=None):
    """The plain version of an iteration's first phase as the kernel fuses
    it: the direction p' = z + β·p (p' = z on a solve's first iteration,
    where p is not read), then :func:`stencil_dot_reference` of p'. Returns
    (p', sm·A·(sm·p'), ⟨p', sm·A·(sm·p')⟩); β is rounded to the fields'
    dtype."""
    if not first:
        b = torch.as_tensor(float(beta), dtype=torch.float64).to(z.dtype)
        z = z + b * p
    return (z, *stencil_dot_reference(A, sm, z, cols))


def precond_reference(sm, r, pcr=None, pcr_z=None):
    """(z, ⟨r, z⟩) for the r-line (``pcr``) or ADI (``pcr`` + ``pcr_z``,
    the rows' and the columns' Thomas factors) preconditioner — the plain
    line-solve phases."""
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


def _check_line_factors(F, name: str = "pcr", line: str = "r") -> None:
    """The r-line operand is :func:`rline_pack`'s (3, Nz, Nr) Thomas
    factors, the z-line operand (``line='z'``) :func:`zline_pack`'s: a
    folded PCR stack in their place (2⌈log2 N⌉+1 planes, 3 only on lines
    of 2 points) raises rather than being misread."""
    if F.ndim < 3 or F.shape[0] != 3:
        raise ValueError(
            f"{name} must be the (3, Nz, Nr) {line}-line Thomas factors of "
            f"{line}line_pack, got shape {tuple(F.shape)} (a folded PCR "
            f"stack from pcr_pack is not this operand)")


def _check_forms(pcr, pcr_z, cheb_degree, merged, mgz, cols=None) -> None:
    """The form checks of the TPU entry point, and the line operands'
    (``pcr``, ``pcr_z``, the mgz coarse rows' ``pcrc``); the ELL form
    (``cols``) is preconditioned by nothing, with the standard
    recurrence."""
    if cols is not None and (pcr is not None or pcr_z is not None
                             or cheb_degree or merged or mgz is not None):
        raise ValueError("the ELL form (cols) has no line, Chebyshev or "
                         "mgz preconditioner and no merged recurrence: it "
                         "solves with the identity")
    if pcr is not None:
        _check_line_factors(pcr)
    if pcr_z is not None:
        _check_line_factors(pcr_z, "pcr_z", "z")
    if mgz is not None:
        _check_line_factors(mgz["pcrc"], "mgz['pcrc']")
    if pcr is not None and cheb_degree:
        raise ValueError("pcr and cheb_degree are mutually exclusive")
    if pcr_z is not None and pcr is None:
        raise ValueError("pcr_z (ADI) requires the r-line pcr stack too")
    if mgz is not None and pcr is None:
        raise ValueError("mgz (z-semicoarsened MG) uses the r-line pcr "
                         "stack as its smoother — pass pcr too")
    if mgz is not None and (pcr_z is not None or merged):
        raise ValueError("mgz is mutually exclusive with pcr_z/merged")


def _guard(v):
    """A divisor as the kernels guard it: v, or 1 where v == 0 (pAp, rz,
    the merged recurrence's gamma, alpha and denominator). v is a Python
    float or a 0-d tensor (guarded on its device, with no host read)."""
    if torch.is_tensor(v):
        return torch.where(v != 0, v, torch.ones_like(v))
    return v if v != 0 else 1.0


def _done(k, rr, stop2, maxiter: int, fixed: bool = False) -> bool:
    """The stop rule: the loop runs while k < maxiter and rr > stop2 (a
    NaN rr stops it); ``fixed`` drops the tolerance test."""
    return not (k < maxiter and (fixed or bool(rr > stop2)))


def _merged_reference(apply_op, precond, r, x, stop2, rr0, maxiter,
                      preconditioned):
    """The Chronopoulos–Gear loop of the TPU kernel on the precomputed
    first residual ``r``: (x, rr, k)."""
    u = precond(r)
    w = apply_op(u)
    gamma = torch.sum(r * u)
    alpha = gamma / _guard(torch.sum(w * u))
    p, q = u, w
    rr = rr0
    k = 0
    while not _done(k, rr, stop2, maxiter):
        x = x + alpha * p
        r = r - alpha * q
        u = precond(r)
        w = apply_op(u)
        gamma_new = torch.sum(r * u)
        delta = torch.sum(w * u)
        rr = torch.sum(r * r) if preconditioned else gamma_new
        beta = gamma_new / _guard(gamma)
        denom = delta - beta * gamma_new / _guard(alpha)
        alpha = gamma_new / _guard(denom)
        p = u + beta * p
        q = w + beta * q
        gamma = gamma_new
        k += 1
    return x, rr, k


def cg_tol_reference(A, sm, b, x0, rtol, *, maxiter: int = 4000,
                     rtol_wrt: str = "r0", pcr=None, pcr_z=None,
                     cheb_degree: int = 0, merged: bool | None = None,
                     mgz=None, mgz_sweeps: int = 1, mgz_omega: float = 0.8,
                     mgz_omega_c: float = 0.8, cols=None):
    """Plain PyTorch version of the kernel, in the inputs' dtype: the
    standard PCG recurrence of the TPU kernel (or, with ``merged``, its
    Chronopoulos–Gear recurrence), with its guards (pAp == 0 → 1,
    rz == 0 → 1), its stop rule (while k < maxiter and rr > stop2, rr = ‖r‖²
    when preconditioned and ⟨r, z⟩ otherwise) and x = NaN when rr is not
    finite. Returns (x, iters) with iters a 0-d int32 tensor. ``cols``:
    the ELL form, A the values of ``ops/ell.py``'s gather."""
    _check_rtol_wrt(rtol_wrt)
    if merged is None:
        merged = MERGED_DEFAULT and cols is None
    _check_forms(pcr, pcr_z, cheb_degree, merged, mgz, cols)
    dtype = b.dtype
    product = operator_product(cols)
    apply_op = lambda y: sm * product(A, sm * y)
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
        while not _done(k, rr, stop2, maxiter):
            Ap = apply_op(p)
            alpha = rz / _guard(torch.sum(p * Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = torch.sum(r * z)
            beta = rz_new / _guard(rz)
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


def _require_factors(pcr, pcr_z, nz: int, nr: int, device) -> None:
    """The line factors given, (3, Nz, Nr) float32 on ``device``."""
    for name, F in (("pcr", pcr), ("pcr_z", pcr_z)):
        if F is not None:
            _require(F, name, (3, nz, nr), device)


def _check_operator(A, sm, device, cols=None):
    """(Nz, Nr) of a kernel operand set: a (7|9, Nz, Nr) stencil, or with
    ``cols`` an ELL operator, its (N, K) float32 values and int32 column
    ids on a (1, N) grid."""
    nz, nr = sm.shape
    _require(sm, "sm", (nz, nr), device)
    if cols is not None:
        if nz != 1 or A.ndim != 2 or A.shape[0] != nr:
            raise ValueError(f"the ELL form's A must be (N, K) on a (1, N) "
                             f"grid, got {tuple(A.shape)} on {(nz, nr)}")
        _require(A, "A", tuple(A.shape), device)
        if (cols.dtype != torch.int32 or cols.shape != A.shape
                or cols.device != device or not cols.is_contiguous()):
            raise ValueError(f"cols must be contiguous int32 {tuple(A.shape)}"
                             f" on {device}, got {cols.dtype} "
                             f"{tuple(cols.shape)} on {cols.device}")
        return nz, nr
    if A.ndim != 3 or A.shape[0] not in (7, 9):
        raise ValueError(f"A must be (7|9, Nz, Nr), got {tuple(A.shape)}")
    _require(A, "A", (A.shape[0], nz, nr), device)
    return nz, nr


def _mgz_operands(mgz, sweeps: int, nz: int, nr: int, device):
    """(Ac9 or None, pcrc, aux) after checking the mgz operand dict; one
    sweep needs no coarse operator."""
    if sweeps < 1:
        raise ValueError(f"mgz_sweeps must be >= 1, got {sweeps}")
    pcrc, aux = mgz["pcrc"], mgz["aux"]
    _require(pcrc, "mgz['pcrc']", (3, nz, nr), device)
    _require(aux, "mgz['aux']", (4, nz, nr), device)
    ac9 = None
    if sweeps > 1:
        ac9 = mgz["Ac9"]
        _require(ac9, "mgz['Ac9']", (9, nz, nr), device)
    return ac9, pcrc, aux


def _check_solve(A, sm, *, pcr, pcr_z, cheb_degree: int, merged: bool, mgz,
                 mgz_sweeps: int, rtol_wrt: str, cols=None) -> None:
    """``cg_tol``'s checks of a solve's form and operands (the right-hand
    side and seed aside), for a solve recorded into another graph
    (``ops/cuda_step``)."""
    with span("transient.operands"):
        _check_rtol_wrt(rtol_wrt)
        _check_forms(pcr, pcr_z, int(cheb_degree), merged, mgz, cols)
        dev = sm.device
        nz, nr = _check_operator(A, sm, dev, cols)
        _require_factors(pcr, pcr_z, nz, nr, dev)
        if mgz is not None:
            _mgz_operands(mgz, int(mgz_sweeps), nz, nr, dev)


def _mgz_tensors(mgz):
    return () if mgz is None else tuple(mgz[k] for k in ("Ac9", "pcrc", "aux")
                                        if k in mgz)


def cg_tol(A: torch.Tensor, sm: torch.Tensor, b: torch.Tensor,
           x0: torch.Tensor, rtol, *, maxiter: int = 4000,
           rtol_wrt: str = "r0", pcr: torch.Tensor | None = None,
           pcr_z: torch.Tensor | None = None, cheb_degree: int = 0,
           merged: bool | None = None, mgz: dict | None = None,
           mgz_sweeps: int = 1, mgz_omega: float = 0.8,
           mgz_omega_c: float = 0.8, cols: torch.Tensor | None = None):
    """Solve sm·A·sm y = b; returns (x, iters) with iters a 0-d int32
    tensor on the inputs' device. ``cols`` (int32 (N, K)) selects the ELL
    form: A the (N, K) values of ``ops/ell.py``'s gather, the fields
    (1, N), preconditioned by nothing. ``rtol`` is a float or a 0-d tensor (read
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
        merged = MERGED_DEFAULT and cols is None
    cheb_degree = int(cheb_degree)
    _check_forms(pcr, pcr_z, cheb_degree, merged, mgz, cols)
    if _on_cpu(A, sm, b, x0, pcr, pcr_z, cols, *_mgz_tensors(mgz)):
        return cg_tol_reference(A, sm, b, x0, rtol, maxiter=maxiter,
                                rtol_wrt=rtol_wrt, pcr=pcr, pcr_z=pcr_z,
                                cheb_degree=cheb_degree, merged=merged,
                                mgz=mgz, mgz_sweeps=mgz_sweeps,
                                mgz_omega=mgz_omega, mgz_omega_c=mgz_omega_c,
                                cols=cols)
    forms = _form_counters(pcr, pcr_z, cheb_degree, merged,
                           mgz is not None, cols is not None)
    return _kernel_solve(A, sm, b, x0, rtol, maxiter=maxiter,
                         rtol_wrt=rtol_wrt, pcr=pcr, pcr_z=pcr_z,
                         cheb_degree=cheb_degree, merged=merged, mgz=mgz,
                         mgz_sweeps=mgz_sweeps, mgz_omega=mgz_omega,
                         mgz_omega_c=mgz_omega_c, poison=True,
                         count=(cg_tol, forms), cols=cols)


def _form_counters(pcr, pcr_z, cheb_degree: int, merged: bool,
                   mgz: bool, ell: bool = False) -> list[str]:
    """The ``cg_tol`` counters one solve of the form adds to."""
    forms = ["launches", "launches_ell" if ell else
             "launches_mgz" if mgz else
             "launches_adi" if pcr_z is not None else
             "launches_rline" if pcr is not None else
             "launches_cheb" if cheb_degree > 0 else "launches_identity"]
    if merged:
        forms.append("launches_merged")
    return forms


def _form_name(pcr, pcr_z, cheb_degree: int, merged: bool, mgz: bool,
               mg: bool = False, ell: bool = False) -> str:
    """A solve form's name: 'rline', 'adi', 'mgz', 'cheb3', 'ell', ...,
    with '_merged' for the merged-dot recurrence."""
    return ("ell" if ell else "mg" if mg else "mgz" if mgz else
            "adi" if pcr_z is not None else "rline" if pcr is not None else
            f"cheb{cheb_degree}" if cheb_degree else "identity") \
        + ("_merged" if merged else "")


class _Recorded:
    """A solve form recorded into a transient's graph (``ops/cuda_step``):
    the launches of a solve's start and finish (``counts``) and of one loop
    body (``counts_body``), and the ``cg_tol`` counters each of its solves
    adds to."""

    def __init__(self, form_name: str, counters: list[str], counts,
                 counts_body):
        self.form_name, self.counters = form_name, counters
        self.counts, self.counts_body = counts, counts_body
        self.capture_s = 0.0


# the solve forms recorded into transients' graphs: the latest capture of
# each form, and [launches, iterations] of its loop bodies since the last
# reset_counters
_recorded: dict[str, _Recorded] = {}
_recorded_runs: dict[str, list] = {}


def _count_solves(g: _Recorded, n: int, runs: int) -> None:
    """Count ``n`` solves that a transient's graph ran on the form of
    ``g``, whose loop bodies ran ``runs`` times (both counted by the
    device): the wrapper's counters and the phase kernels' launches."""
    global _phase_counts
    for name in g.counters:
        setattr(cg_tol, name, getattr(cg_tol, name) + int(n))
    _phase_counts += int(n) * g.counts + int(runs) * g.counts_body
    acc = _recorded_runs.setdefault(g.form_name, [0, 0])
    acc[0] += int(runs) * int(g.counts_body.sum())
    acc[1] += int(runs) * CHECK_EVERY


class _Graph:
    """One captured solve: the executable CUDA graph, the launches of its
    start and finish (``counts``, added where the graph is launched), those
    of one loop body (``counts_body``) and the device's count of body runs
    (``runs``, int64)."""

    def __init__(self, lib, exec_ptr: int, counts, counts_body, runs,
                 capture_s: float):
        self.lib, self.exec_ptr = lib, exec_ptr
        self.counts, self.counts_body, self.runs = counts, counts_body, runs
        self.capture_s = capture_s

    def __del__(self):
        self.lib.hf_graph_destroy(self.exec_ptr)


class _Workspace:
    """The buffers of one solve form at one shape on one device, and the
    graphs captured on them: a graph reads and writes these buffers, so it
    stays valid across the solves of a transient or a fit. The caller's b,
    x0 and scalars are copied in before a launch; x is copied out."""

    def __init__(self, lib, dev, nz: int, nr: int, n_extra: int,
                 form_name: str):
        f32 = dict(dtype=torch.float32, device=dev)
        self.form_name = form_name
        self.b = torch.empty((nz, nr), **f32)
        self.x0 = torch.empty((nz, nr), **f32)
        self.x = torch.empty((nz, nr), **f32)
        # r, z, Ap, then p's two planes (the even and odd iterations')
        self.vecs = torch.empty((5, nz, nr), **f32)
        self.extra = torch.empty((n_extra, nz, nr), **f32) if n_extra \
            else None
        self.parts = torch.empty((4, lib.hf_cg_nparts(nz, nr)),
                                 dtype=torch.float64, device=dev)
        self.state = torch.empty(8, dtype=torch.float64, device=dev)
        self.rtol = torch.empty((), **f32)
        self.lmax = torch.empty(1, **f32)
        self.iters = torch.empty((), dtype=torch.int32, device=dev)
        self.graphs: OrderedDict = OrderedDict()


_workspaces: dict = {}


def _workspace(lib, dev, nz: int, nr: int, form: tuple, n_extra: int,
               form_name: str) -> _Workspace:
    """The workspace of (device, shape, form), made at its first use."""
    key = (str(dev), nz, nr, form)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = _Workspace(lib, dev, nz, nr, n_extra,
                                           form_name)
    return ws


def _retire(g: _Graph) -> None:
    """Fold an evicted graph's device-counted launches into the host
    counts before it goes."""
    global _phase_counts
    _phase_counts += int(g.runs.item()) * g.counts_body


def _kernel_solve(A, sm, b, x0, rtol, *, maxiter: int, rtol_wrt: str = "r0",
                  pcr=None, pcr_z=None, cheb_degree: int = 0,
                  merged: bool = False, mgz=None, mgz_sweeps: int = 1,
                  mgz_omega: float = 0.8, mgz_omega_c: float = 0.8, mg=None,
                  fixed: bool = False, poison: bool = False,
                  count=None, what: str = "cg_tol", cols=None):
    """One solve through the phase kernels of ``csrc/cg_tol.cu`` on CUDA
    float32 tensors: (x, iters). The solve is one CUDA graph launch: the
    graph is captured once per workspace (see :class:`_Workspace`) and set
    of operands, then replayed. ``mg`` (a function of the z plane that
    returns the multigrid descriptor, see ``ops/cuda_mg``) selects the
    V-cycle preconditioner; ``fixed`` runs ``maxiter`` iterations with the
    stop test off; ``poison`` makes x NaN when the residual is not finite
    (``cg_tol``'s contract); ``count`` (a wrapper function and the names of
    its launch counts) is counted where the solve is launched; ``cols``
    the ELL form's column ids."""
    lib = _library()
    dev = b.device
    nz, nr = _check_operator(A, sm, dev, cols)
    _require(b, "b", (nz, nr), dev)
    _require(x0, "x0", (nz, nr), dev)
    _require_factors(pcr, pcr_z, nz, nr, dev)
    ac9 = pcrc = aux = None
    if mgz is not None:
        ac9, pcrc, aux = _mgz_operands(mgz, int(mgz_sweeps), nz, nr, dev)
    rtol_t = torch.as_tensor(rtol, dtype=torch.float32, device=dev)
    if rtol_t.numel() != 1:
        raise ValueError("rtol must be a scalar")

    form = (pcr is not None, pcr_z is not None, cheb_degree, bool(merged),
            mgz is not None, mg is not None, cols is not None)
    name = _form_name(pcr, pcr_z, cheb_degree, merged, mgz is not None,
                      mg is not None, cols is not None)
    ws = _workspace(lib, dev, nz, nr, form,
                    lib.hf_cg_extra_planes(cheb_degree, int(merged),
                                           int(mgz is not None)), name)
    ws.b.copy_(b)
    ws.x0.copy_(x0)
    ws.rtol.copy_(rtol_t.reshape(()))
    if cheb_degree > 0:
        ws.lmax.copy_(gershgorin_lmax(A, sm).reshape(1))
    r, z, Ap, p, _ = ws.vecs.unbind(0)
    if pcr is None and cheb_degree == 0 and mg is None:
        z = r                         # identity form: z aliases r
    desc = None if mg is None else mg(z)
    npts = A.shape[0] if cols is None else A.shape[1]
    args = (_ptr(A), npts, _ptr(sm), _ptr(ws.b), _ptr(ws.x0),
            _ptr(ws.rtol), _ptr(pcr), _ptr(pcr_z), _ptr(ws.x),
            _ptr(r), _ptr(z), _ptr(p), _ptr(Ap), _ptr(ws.parts),
            ws.parts.shape[1], _ptr(ws.state), nz, nr, int(maxiter),
            int(rtol_wrt == "r0"))
    extra = (_ptr(ws.lmax), cheb_degree, int(merged), _ptr(ac9), _ptr(pcrc),
             _ptr(aux), int(mgz_sweeps), float(mgz_omega),
             float(mgz_omega_c), _ptr(ws.extra),
             None if desc is None else ctypes.addressof(desc), int(fixed),
             _ptr(cols))
    # the descriptor's address changes from call to call, its content
    # (the levels' pointers and coefficients) is what the graph holds
    key = args + extra[:-3] + (int(fixed), _ptr(cols), int(poison),
                               None if desc is None else bytes(desc))
    graph = ws.graphs.get(key)
    if graph is None:
        counts = np.zeros(len(PHASES), dtype=np.int64)
        counts_body = np.zeros(len(PHASES), dtype=np.int64)
        runs = torch.zeros(1, dtype=torch.int64, device=dev)
        handle = ctypes.c_void_p()
        t0 = time.perf_counter()
        _check(lib.hf_cg_tol_graph(
            *args, ctypes.c_void_p(counts.ctypes.data), *extra,
            CHECK_EVERY, int(poison), _ptr(ws.iters), _ptr(runs),
            ctypes.c_void_p(counts_body.ctypes.data),
            ctypes.byref(handle)), f"{what} capture")
        graph = ws.graphs[key] = _Graph(lib, handle.value, counts,
                                        counts_body, runs,
                                        time.perf_counter() - t0)
        while len(ws.graphs) > GRAPHS_KEPT:
            _retire(ws.graphs.popitem(last=False)[1])
    else:
        ws.graphs.move_to_end(key)

    if count is not None:
        fn, names = count
        for name in names:
            setattr(fn, name, getattr(fn, name) + 1)
    _check(lib.hf_graph_launch(graph.exec_ptr, _stream()), f"{what} launch")
    _phase_counts[:] += graph.counts
    return ws.x.clone(), ws.iters.clone()


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
    if pcr is not None:
        _require(pcr, "pcr", (3, nz, nr), dev)
    ac9 = pcrc = aux = lmax = None
    if mgz is not None:
        ac9, pcrc, aux = _mgz_operands(mgz, int(mgz_sweeps), nz, nr, dev)
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
        _ptr(A), A.shape[0], _ptr(sm), _ptr(r), _ptr(pcr), _ptr(z),
        _ptr(parts), nparts, nz, nr, _counts_ptr(), _stream(), _ptr(lmax),
        int(cheb_degree), _ptr(ac9), _ptr(pcrc), _ptr(aux),
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


_STATE_FIELDS = ("rz", "rr", "stop2", "alpha", "beta")


def _state(device, **fields) -> torch.Tensor:
    """A solve-state record (8 float64 words: rz, rr, stop2, alpha, beta,
    then the int32 count and done flag in words 10 and 11 of its int32
    view, the tails' block tickets in words 12 and 13); fields not given
    are 0."""
    st = torch.zeros(8, dtype=torch.float64, device=device)
    for i, name in enumerate(_STATE_FIELDS):
        if name in fields:
            st[i] = float(fields[name])
    ints = st.view(torch.int32)
    ints[10] = int(fields.get("k", 0))
    ints[11] = int(fields.get("done", 0))
    return st


def _read_state(st: torch.Tensor) -> dict:
    host = st.cpu()
    ints = host.view(torch.int32)
    out = {name: float(host[i]) for i, name in enumerate(_STATE_FIELDS)}
    out.update(k=int(ints[10]), done=int(ints[11]))
    return out


def finalize_reference(state: dict, mode: str, *, pap=None, rr=None,
                       rz=None, bb=None, preconditioned: bool = True,
                       rtol=0.0, maxiter: int = 4000, rtol_wrt: str = "r0",
                       fixed: bool = False) -> dict:
    """The standard recurrence's scalar step in Python floats on a state
    dict (rz, rr, stop2, alpha, beta, k, done), as ``k_finalize`` and the
    kernels' alpha and beta tails take it: ``'init'`` (the stop target from
    ⟨r0, r0⟩ or ⟨b, b⟩ and rtol rounded to float32), ``'alpha'``
    (rz / pAp, pAp == 0 → 1) or ``'beta'`` (β = rz' / rz, rz == 0 → 1;
    rr is ⟨r, r⟩ when preconditioned, else rz; k += 1). The loop runs
    while k < maxiter and rr > stop2 (a NaN rr stops it); ``fixed`` drops
    the tolerance test. Returns the new dict; a done state is left as it
    is, but for 'init'."""
    if mode not in ("init", "alpha", "beta"):
        raise ValueError(f"mode must be 'init', 'alpha' or 'beta': {mode!r}")
    st = dict(state)
    if mode != "init" and st.get("done"):
        return st
    if mode == "alpha":
        st["alpha"] = st["rz"] / _guard(float(pap))
        return st
    rr = float(rr)
    rz = rr if rz is None else float(rz)
    if mode == "init":
        rt = float(np.float32(rtol))
        st.update(rz=rz, rr=rr, alpha=0.0, beta=0.0, k=0,
                  stop2=rt * rt * (rr if rtol_wrt == "r0" else float(bb)))
    else:
        st.update(beta=rz / _guard(st["rz"]), rz=rz,
                  rr=rr if preconditioned else rz, k=st["k"] + 1)
    st["done"] = int(_done(st["k"], st["rr"], st["stop2"], maxiter, fixed))
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
    delta, rr, gamma, bb = (float(v) for v in (delta, rr, gamma, bb))
    st = dict(state)
    if first:
        rt = float(np.float32(rtol))
        st.update(rz=gamma, rr=rr,
                  stop2=rt * rt * (rr if rtol_wrt == "r0" else bb),
                  alpha=gamma / _guard(delta), beta=0.0, k=0)
    else:
        if st.get("done"):
            return st
        beta = gamma / _guard(st["rz"])
        denom = delta - beta * gamma / _guard(st["alpha"])
        st.update(alpha=gamma / _guard(denom), beta=beta, rz=gamma,
                  rr=rr if preconditioned else gamma, k=st["k"] + 1)
    st["done"] = int(_done(st["k"], st["rr"], st["stop2"], maxiter))
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
    return _read_state(st)


def mgz_pre_reference(r, pcr, omega: float, *, x=None, p=None, Ap=None,
                      alpha=None):
    """Plain version of :func:`mgz_pre`: (x + α·p, r − α·Ap, z, ⟨r, r⟩
    float64) with the update (``alpha`` given, rounded to the fields'
    dtype), or (None, r, z, None) without; z = ω·T⁻¹r, the rows' line
    solves from the Thomas factors ``pcr``."""
    rr = None
    if alpha is not None:
        a = torch.as_tensor(float(alpha), dtype=torch.float64).to(r.dtype)
        x = x + a * p
        r = r - a * Ap
        rr = (r.double() * r.double()).sum()
    return x, r, omega * thomas_apply_lines(pcr, r), rr


def mgz_coarse_reference(A, sm, r, z, aux, pcrc, omega_c: float):
    """Plain version of :func:`mgz_coarse`: (yc, rcs). The fine residual
    r − sm·A·(sm·z) restricted onto the embedded coarse rows, rcs, and the
    damped coarse line solve from zero, yc = ω_c·Tc⁻¹rcs (``pcrc``: the
    coarse rows' Thomas factors). Every restriction weight is 0 on an odd
    row (``ops/mgz.py``), and its couplings are 0: there rcs = 0 and so is
    its solve."""
    rc = restrict(aux, r - sm * apply_stencil(A, sm * z))
    rcs = torch.zeros_like(rc)
    rcs[0::2] = rc[0::2]
    return omega_c * thomas_apply_lines(pcrc, rcs), rcs


def mgz_coarse_res_reference(Ac9, rcs, y, pcrc, omega_c: float):
    """Plain version of :func:`mgz_coarse_res`: a later coarse sweep,
    y + ω_c·Tc⁻¹(rcs − Ac9·y) on the even rows and y + ω_c·0 on the odd
    rows (where rcs and y are 0: see :func:`mgz_coarse_reference`)."""
    d = torch.zeros_like(y)
    d[0::2] = (rcs - coarse_apply(Ac9, y))[0::2]
    return y + omega_c * thomas_apply_lines(pcrc, d)


def mgz_prolong_res_reference(A, sm, r, z, yc, aux):
    """Plain version of :func:`mgz_prolong_res`: (zp = z + P(sc·yc),
    r − sm·A·(sm·zp))."""
    zp = prolong(aux, z, yc)
    return zp, r - sm * apply_stencil(A, sm * zp)


def mgz_post_reference(r1, zp, pcr, omega: float, sm, r):
    """Plain version of :func:`mgz_post`: (z = (zp + ω·T⁻¹r1)·free,
    ⟨r, z⟩ float64)."""
    z = (zp + omega * thomas_apply_lines(pcr, r1)) * (sm != 0).to(zp.dtype)
    return z, (r.double() * z.double()).sum()


def mgz_cycle_reference(A, sm, r, pcr, mgz, sweeps: int = 1,
                        omega: float = 0.8, omega_c: float = 0.8):
    """The mgz V-cycle as the kernel runs it, from the plain versions of its
    passes: pre-smoothing row, coarse row with the fine residual, further
    coarse sweeps, prolongation with the second residual, post-smoothing
    row. Returns (z, ⟨r, z⟩); z equals :func:`mgz_precond_reference`'s."""
    _, _, z, _ = mgz_pre_reference(r, pcr, omega)
    yc, rcs = mgz_coarse_reference(A, sm, r, z, mgz["aux"], mgz["pcrc"],
                                   omega_c)
    for _ in range(sweeps - 1):
        yc = mgz_coarse_res_reference(mgz["Ac9"], rcs, yc, mgz["pcrc"],
                                      omega_c)
    zp, r1 = mgz_prolong_res_reference(A, sm, r, z, yc, mgz["aux"])
    return mgz_post_reference(r1, zp, pcr, omega, sm, r)


def mgz_pre(r, pcr, omega: float, *, x=None, p=None, Ap=None, state=None):
    """The mgz cycle's pre-smoothing row alone: z = ω·T⁻¹r; with a state
    dict (its alpha, as :func:`finalize_reference` takes it), after the CG
    update of the row as an iteration runs it. Returns (x + α·p, r − α·Ap,
    z, ⟨r, r⟩) or (None, r, z, None); the inputs are left as they are."""
    _check_line_factors(pcr)
    if _on_cpu(r, pcr, x, p, Ap):
        return mgz_pre_reference(r, pcr, omega, x=x, p=p, Ap=Ap,
                                 alpha=None if state is None
                                 else state["alpha"])
    lib = _library()
    dev = r.device
    nz, nr = r.shape
    _require(r, "r", (nz, nr), dev)
    _require(pcr, "pcr", (3, nz, nr), dev)
    z = torch.empty_like(r)
    part = torch.zeros(lib.hf_cg_nparts(nz, nr), dtype=torch.float64,
                       device=dev)
    st = None
    if state is not None:
        for name, t in (("x", x), ("p", p), ("Ap", Ap)):
            _require(t, name, (nz, nr), dev)
        x, r = x.clone(), r.clone()
        st = _state(dev, **state)
    _check(lib.hf_mgz_pre(_ptr(r), _ptr(x), _ptr(p), _ptr(Ap), _ptr(pcr),
                          float(omega), _ptr(z), _ptr(part), _ptr(st), nz, nr,
                          _counts_ptr(), _stream()), "mgz_pre")
    return x, r, z, None if state is None else part[:nz].sum()


def mgz_coarse(A, sm, r, z, aux, pcrc, omega_c: float):
    """The mgz cycle's first coarse sweep alone: (yc, rcs), see
    :func:`mgz_coarse_reference`."""
    _check_line_factors(pcrc, "pcrc")
    if _on_cpu(A, sm, r, z, aux, pcrc):
        return mgz_coarse_reference(A, sm, r, z, aux, pcrc, omega_c)
    lib = _library()
    dev = r.device
    nz, nr = _check_operator(A, sm, dev)
    for name, t in (("r", r), ("z", z)):
        _require(t, name, (nz, nr), dev)
    _require(aux, "aux", (4, nz, nr), dev)
    _require(pcrc, "pcrc", (3, nz, nr), dev)
    yc, rcs = torch.empty_like(r), torch.empty_like(r)
    _check(lib.hf_mgz_coarse(_ptr(A), A.shape[0], _ptr(sm), _ptr(r), _ptr(z),
                             _ptr(aux), _ptr(pcrc), float(omega_c),
                             _ptr(yc), _ptr(rcs), nz, nr, _counts_ptr(),
                             _stream()), "mgz_coarse")
    return yc, rcs


def mgz_coarse_res(Ac9, rcs, y, pcrc, omega_c: float):
    """A later coarse sweep of the mgz cycle alone, see
    :func:`mgz_coarse_res_reference`."""
    _check_line_factors(pcrc, "pcrc")
    if _on_cpu(Ac9, rcs, y, pcrc):
        return mgz_coarse_res_reference(Ac9, rcs, y, pcrc, omega_c)
    lib = _library()
    dev = y.device
    nz, nr = y.shape
    _require(Ac9, "Ac9", (9, nz, nr), dev)
    _require(rcs, "rcs", (nz, nr), dev)
    _require(y, "y", (nz, nr), dev)
    _require(pcrc, "pcrc", (3, nz, nr), dev)
    out = torch.empty_like(y)
    _check(lib.hf_mgz_coarse_res(_ptr(Ac9), _ptr(rcs), _ptr(y), _ptr(pcrc),
                                 float(omega_c), _ptr(out), nz, nr,
                                 _counts_ptr(), _stream()), "mgz_coarse_res")
    return out


def mgz_prolong_res(A, sm, r, z, yc, aux):
    """The mgz cycle's prolongation with its second residual alone: (zp,
    r1), see :func:`mgz_prolong_res_reference`."""
    if _on_cpu(A, sm, r, z, yc, aux):
        return mgz_prolong_res_reference(A, sm, r, z, yc, aux)
    lib = _library()
    dev = r.device
    nz, nr = _check_operator(A, sm, dev)
    for name, t in (("r", r), ("z", z), ("yc", yc)):
        _require(t, name, (nz, nr), dev)
    _require(aux, "aux", (4, nz, nr), dev)
    zp, r1 = torch.empty_like(r), torch.empty_like(r)
    _check(lib.hf_mgz_prolong_res(_ptr(A), A.shape[0], _ptr(sm), _ptr(r),
                                  _ptr(z), _ptr(yc), _ptr(aux), _ptr(zp),
                                  _ptr(r1), nz, nr, _counts_ptr(), _stream()),
           "mgz_prolong_res")
    return zp, r1


def mgz_post(r1, zp, pcr, omega: float, sm, r, *, state=None, rr=None,
             maxiter: int = 4000, fixed: bool = False):
    """The mgz cycle's post-smoothing row alone: (z, ⟨r, z⟩) as
    :func:`mgz_post_reference`; with a state dict and ⟨r, r⟩ (``rr``), also
    the state after the beta tail the solve takes in this kernel."""
    _check_line_factors(pcr)
    if _on_cpu(r1, zp, pcr, sm, r):
        z, rz = mgz_post_reference(r1, zp, pcr, omega, sm, r)
        if state is None:
            return z, rz
        return z, rz, finalize_reference(state, "beta", rr=rr, rz=rz,
                                         maxiter=maxiter, fixed=fixed)
    lib = _library()
    dev = r.device
    nz, nr = r.shape
    for name, t in (("r1", r1), ("zp", zp), ("sm", sm), ("r", r)):
        _require(t, name, (nz, nr), dev)
    _require(pcr, "pcr", (3, nz, nr), dev)
    z = torch.empty_like(r)
    nparts = lib.hf_cg_nparts(nz, nr)
    parts = torch.zeros((4, nparts), dtype=torch.float64, device=dev)
    st = None
    if state is not None:
        parts[1, 0] = float(rr)
        st = _state(dev, **state)
    _check(lib.hf_mgz_post(_ptr(r1), _ptr(zp), _ptr(pcr), float(omega),
                           _ptr(sm), _ptr(r), _ptr(z), _ptr(parts), nparts, 1,
                           _ptr(st), int(maxiter), int(fixed), nz, nr,
                           _counts_ptr(), _stream()), "mgz_post")
    rz = parts[2, :nz].sum()
    return (z, rz) if state is None else (z, rz, _read_state(st))


def stencil_dot(A: torch.Tensor, sm: torch.Tensor, p: torch.Tensor):
    """The kernel's stencil-and-dot phase alone: (Ap, ⟨p, Ap⟩) with
    Ap = sm·A·(sm·p); ⟨p, Ap⟩ is a float64 0-d tensor. With no state record
    the kernel runs as on a solve's first iteration, p' = z (here p)."""
    if _on_cpu(A, sm, p):
        return stencil_dot_reference(A, sm, p)
    lib = _library()
    nz, nr = _check_operator(A, sm, p.device)
    _require(p, "p", (nz, nr), p.device)
    _, Ap, part = _stencil_dot_launch(lib, A, sm, p, p, None)
    return Ap, part.sum()


def _stencil_dot_launch(lib, A, sm, z, p, state):
    nz, nr = sm.shape
    p_n, Ap = torch.empty_like(z), torch.empty_like(z)
    part = torch.zeros((nz * nr + 255) // 256, dtype=torch.float64,
                       device=z.device)
    _check(lib.hf_stencil_dot(_ptr(A), A.shape[0], _ptr(sm), _ptr(z),
                              _ptr(p), _ptr(p_n), _ptr(Ap), _ptr(part),
                              _ptr(state), nz, nr, _counts_ptr(), _stream()),
           "stencil_dot")
    return p_n, Ap, part


def stencil_dot_p(A: torch.Tensor, sm: torch.Tensor, z: torch.Tensor,
                  p: torch.Tensor, state: dict):
    """An iteration's first phase alone, as a solve runs it on ``state``
    (a dict as :func:`finalize_reference` takes): (p' = z + β·p, or z when
    the state's count k is 0, Ap = sm·A·(sm·p'), ⟨p', Ap⟩, the state after
    the alpha tail); the inputs are left as they are."""
    first = state.get("k", 0) == 0
    if _on_cpu(A, sm, z, p):
        p_n, Ap, pap = stencil_dot_p_reference(A, sm, z, p,
                                               state.get("beta", 0.0), first)
        return p_n, Ap, pap, finalize_reference(state, "alpha", pap=pap)
    lib = _library()
    nz, nr = _check_operator(A, sm, z.device)
    _require(z, "z", (nz, nr), z.device)
    _require(p, "p", (nz, nr), z.device)
    st = _state(z.device, **state)
    p_n, Ap, part = _stencil_dot_launch(lib, A, sm, z, p, st)
    return p_n, Ap, part.sum(), _read_state(st)


def ell_dot(A: torch.Tensor, cols: torch.Tensor, sm: torch.Tensor,
            z: torch.Tensor, p: torch.Tensor, state: dict | None = None):
    """The ELL form's first phase alone (``k_ell_dot``), as a solve runs it
    on ``state`` (a dict as :func:`finalize_reference` takes; None: a
    solve's first iteration, no tail): (p' = z + β·p, or z when the count
    k is 0, Ap = sm·A·(sm·p'), ⟨p', Ap⟩, the state after the alpha tail or
    None); the inputs are left as they are. A (N, K) values, cols int32,
    the fields (1, N)."""
    first = state is None or state.get("k", 0) == 0
    if _on_cpu(A, cols, sm, z, p):
        beta = 0.0 if state is None else state.get("beta", 0.0)
        p_n, Ap, pap = stencil_dot_p_reference(A, sm, z, p, beta, first,
                                               cols)
        return p_n, Ap, pap, None if state is None else finalize_reference(
            state, "alpha", pap=pap)
    lib = _library()
    nz, nr = _check_operator(A, sm, z.device, cols)
    _require(z, "z", (nz, nr), z.device)
    _require(p, "p", (nz, nr), z.device)
    st = None if state is None else _state(z.device, **state)
    p_n, Ap = torch.empty_like(z), torch.empty_like(z)
    part = torch.zeros((nr + 255) // 256, dtype=torch.float64,
                       device=z.device)
    _check(lib.hf_ell_dot(_ptr(A), _ptr(cols), A.shape[1], _ptr(sm), _ptr(z),
                          _ptr(p), _ptr(p_n), _ptr(Ap), _ptr(part), _ptr(st),
                          nr, _counts_ptr(), _stream()), "ell_dot")
    return p_n, Ap, part.sum(), None if st is None else _read_state(st)


def precond(sm: torch.Tensor, r: torch.Tensor, pcr: torch.Tensor,
            pcr_z: torch.Tensor | None = None):
    """The kernel's line-solve phases alone: (z, ⟨r, z⟩) with z the r-line
    (``pcr``) or ADI (``pcr`` + ``pcr_z``) preconditioned residual;
    ⟨r, z⟩ is a float64 0-d tensor."""
    _check_line_factors(pcr)
    if pcr_z is not None:
        _check_line_factors(pcr_z, "pcr_z", "z")
    if _on_cpu(sm, r, pcr, pcr_z):
        return precond_reference(sm, r, pcr, pcr_z)
    lib = _library()
    dev = r.device
    nz, nr = sm.shape
    _require(sm, "sm", (nz, nr), dev)
    _require(r, "r", (nz, nr), dev)
    _require_factors(pcr, pcr_z, nz, nr, dev)
    z = torch.empty_like(r)
    part = torch.zeros(lib.hf_cg_nparts(nz, nr), dtype=torch.float64,
                       device=dev)
    stream = _stream()
    _check(lib.hf_pcr_r(_ptr(r), _ptr(sm), _ptr(pcr), _ptr(z), _ptr(part),
                        nz, nr, _counts_ptr(), stream), "pcr_r")
    if pcr_z is None:
        return z, part.sum()
    part.zero_()
    _check(lib.hf_pcr_z(_ptr(r), _ptr(sm), _ptr(pcr_z), _ptr(z), _ptr(part),
                        nz, nr, _counts_ptr(), stream), "pcr_z")
    return z, part.sum()


def update_precond_reference(x, r, p, Ap, alpha, sm, pcr, pcr_z=None):
    """Plain version of :func:`update_precond`: (x + α·p, r − α·Ap, z,
    ⟨r, r⟩, ⟨r, z⟩) with the new r, α rounded to the fields' dtype; the
    sums are float64, summed a grid row at a time (a z-line tile for ⟨r, z⟩
    in the ADI form, one column here) in the order of the kernel's
    partials, then over the rows (columns)."""
    a = torch.as_tensor(float(alpha), dtype=torch.float64).to(x.dtype)
    x = x + a * p
    r = r - a * Ap
    z, _ = precond_reference(sm, r, pcr, pcr_z)
    r64 = r.double()
    rr = (r64 * r64).sum(dim=1).sum()
    rz = (r64 * z.double()).sum(dim=0 if pcr_z is not None else 1).sum()
    return x, r, z, rr, rz


def update_precond(x, r, p, Ap, sm, pcr, pcr_z=None, *, state: dict,
                   maxiter: int = 4000, fixed: bool = False):
    """The r-line (``pcr``) or ADI (``pcr``, ``pcr_z``) solve's fused phase
    alone, as an iteration runs it on ``state``'s alpha: (x + α·p, r − α·Ap,
    z = M⁻¹r, ⟨r, r⟩, ⟨r, z⟩, the state after the beta tail); the inputs
    are left as they are."""
    _check_line_factors(pcr)
    if pcr_z is not None:
        _check_line_factors(pcr_z, "pcr_z", "z")
    if _on_cpu(x, r, p, Ap, sm, pcr, pcr_z):
        x, r, z, rr, rz = update_precond_reference(
            x, r, p, Ap, state["alpha"], sm, pcr, pcr_z)
        return x, r, z, rr, rz, finalize_reference(
            state, "beta", rr=rr, rz=rz, preconditioned=True,
            maxiter=maxiter, fixed=fixed)
    lib = _library()
    dev = r.device
    nz, nr = sm.shape
    for name, t in (("x", x), ("r", r), ("p", p), ("Ap", Ap), ("sm", sm)):
        _require(t, name, (nz, nr), dev)
    _require_factors(pcr, pcr_z, nz, nr, dev)
    x_n, r_n, z = x.clone(), r.clone(), torch.empty_like(r)
    parts = torch.zeros((4, lib.hf_cg_nparts(nz, nr)), dtype=torch.float64,
                        device=dev)
    st = _state(dev, **state)
    _check(lib.hf_update_pcr(_ptr(x_n), _ptr(r_n), _ptr(p), _ptr(Ap),
                             _ptr(sm), _ptr(pcr), _ptr(pcr_z), _ptr(z),
                             _ptr(parts), parts.shape[1], _ptr(st),
                             int(maxiter), int(fixed), nz, nr, _counts_ptr(),
                             _stream()), "update_pcr")
    return x_n, r_n, z, parts[1].sum(), parts[2].sum(), _read_state(st)


def _implicit_cg(solver, A, sm, b, x0, rtol, maxiter, rtol_wrt, pcr, pcr_z,
                 count: bool) -> torch.Tensor:
    """The implicitly differentiated solve of sm·A·sm y = b, each solve by
    ``solver`` (:func:`cg_tol` or its plain version)."""
    def solve(rhs, direction, A, sm, b, x0, pcr, pcr_z):
        if rhs.ndim == 3:     # a batch of right-hand sides (torch.func.vmap)
            return torch.stack([solve(v, direction, A, sm, b, x0, pcr,
                                      pcr_z) for v in rhs])
        # cg_tol's right-hand side vanishes at constrained dofs (sm = 0),
        # where the operator's rows are 0. A cotangent need not, and its
        # entries there reach no entry of the solution; left in, they would
        # hold the residual above every stop, and float32 CG run to maxiter
        # past convergence drifts through underflow into overflow.
        rhs = rhs * (sm != 0).to(rhs.dtype)
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
    the ``pcr`` and ``pcr_z`` factors (:func:`rline_pack`,
    :func:`zline_pack`) only steer the solves and are detached.
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
