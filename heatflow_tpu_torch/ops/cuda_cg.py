"""Tolerance-stopped PCG on the scaled stencil operator: the CUDA kernel
(``csrc/cg_tol.cu``) and its plain PyTorch version.

``cg_tol`` solves sm·A·sm y = b, with b and x0 vanishing at constrained
dofs and sm = rsqrt(diag(A))·free, preconditioned by nothing, by the r-line
PCR block-Jacobi solve (``pcr``) or by the split-additive ADI solve
R r + Z r − r (``pcr`` and ``pcr_z``), stopping on the true residual
‖r‖ ≤ rtol·‖r0‖ (``rtol_wrt='r0'``) or rtol·‖b‖ (``'b'``). A tensor on the
CPU goes to :func:`cg_tol_reference`; a CUDA tensor goes to the kernel, or
the call raises. The kernel replaces heatflow_tpu/ops/pallas_cg.py:
_cg_tol_kernel; the PCR factor stacks it consumes are packed once per
transient by :func:`pcr_pack`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from heatflow_tpu_torch.ops.cg import implicit_solve
from heatflow_tpu_torch.ops.linesolve import (line_couplings, pcr_factor,
                                              pcr_fold)
from heatflow_tpu_torch.ops.stencil import apply_stencil, shifted

CHECK_EVERY = 8   # CG iterations enqueued between two host reads of the
                  # device-side stop flag; the iterate and the count do not
                  # depend on it (every phase is a no-op once the flag is set)

PHASES = ("init", "stencil_dot", "update", "pcr_r", "pcr_z", "finalize",
          "p_update", "finish")
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


def reset_counters() -> None:
    _phase_counts[:] = 0
    for name in ("launches", "launches_identity", "launches_rline",
                 "launches_adi"):
        setattr(cg_tol, name, 0)
    for name in ("launches_forward", "launches_backward", "launches_jvp"):
        setattr(cg_vmem_solve, name, 0)


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


def _precond_reference(sm, pcr, pcr_z):
    free = (sm != 0).to(sm.dtype)
    if pcr_z is not None:
        return lambda r: (pcr_stack_apply(pcr, r, -1)
                          + pcr_stack_apply(pcr_z, r, -2) - r) * free
    if pcr is not None:
        return lambda r: pcr_stack_apply(pcr, r, -1) * free
    return lambda r: r


def stencil_dot_reference(A, sm, p):
    """(sm·A·(sm·p), ⟨p, sm·A·(sm·p)⟩) — the plain stencil-and-dot phase."""
    Ap = sm * apply_stencil(A, sm * p)
    return Ap, (p.double() * Ap.double()).sum()


def precond_reference(sm, r, pcr=None, pcr_z=None):
    """(z, ⟨r, z⟩) for the r-line (``pcr``) or ADI (``pcr`` + ``pcr_z``)
    preconditioner — the plain PCR phases."""
    z = _precond_reference(sm, pcr, pcr_z)(r)
    return z, (r.double() * z.double()).sum()


def cg_tol_reference(A, sm, b, x0, rtol, *, maxiter: int = 4000,
                     rtol_wrt: str = "r0", pcr=None, pcr_z=None):
    """Plain PyTorch version of the kernel, in the inputs' dtype: the
    standard PCG recurrence of the TPU kernel, with its guards (pAp == 0 → 1,
    rz == 0 → 1), its stop rule (while k < maxiter and rr > stop2, rr = ‖r‖²
    when preconditioned and ⟨r, z⟩ otherwise) and x = NaN when rr is not
    finite. Returns (x, iters) with iters a 0-d int32 tensor."""
    _check_rtol_wrt(rtol_wrt)
    if pcr_z is not None and pcr is None:
        raise ValueError("pcr_z (ADI) requires the r-line pcr stack too")
    dtype = b.dtype
    one = torch.ones((), dtype=dtype, device=b.device)
    apply_op = lambda y: sm * apply_stencil(A, sm * y)
    precond = _precond_reference(sm, pcr, pcr_z)
    preconditioned = pcr is not None
    rtol = torch.as_tensor(rtol, dtype=dtype, device=b.device)

    x = x0
    r = b - apply_op(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    rr = torch.sum(r * r)
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


def cg_tol(A: torch.Tensor, sm: torch.Tensor, b: torch.Tensor,
           x0: torch.Tensor, rtol, *, maxiter: int = 4000,
           rtol_wrt: str = "r0", pcr: torch.Tensor | None = None,
           pcr_z: torch.Tensor | None = None):
    """Solve sm·A·sm y = b; returns (x, iters) with iters a 0-d int32
    tensor on the inputs' device. ``rtol`` is a float or a 0-d tensor (read
    on the device, no host sync). CPU tensors take the plain version; CUDA
    float32 tensors take the kernel."""
    _check_rtol_wrt(rtol_wrt)
    if pcr_z is not None and pcr is None:
        raise ValueError("pcr_z (ADI) requires the r-line pcr stack too")
    if _on_cpu(A, sm, b, x0, pcr, pcr_z):
        return cg_tol_reference(A, sm, b, x0, rtol, maxiter=maxiter,
                                rtol_wrt=rtol_wrt, pcr=pcr, pcr_z=pcr_z)
    lib = _library()
    dev = b.device
    nz, nr = _check_operator(A, sm, dev)
    _require(b, "b", (nz, nr), dev)
    _require(x0, "x0", (nz, nr), dev)
    lr = 0 if pcr is None else _stack_levels(pcr, "pcr", nz, nr, dev)
    lz = 0 if pcr_z is None else _stack_levels(pcr_z, "pcr_z", nz, nr, dev)
    rtol_t = torch.as_tensor(rtol, dtype=torch.float32, device=dev)
    if rtol_t.numel() != 1:
        raise ValueError("rtol must be a scalar")
    rtol_t = rtol_t.reshape(()).contiguous()

    x = torch.empty_like(b)
    vecs = torch.empty((4, nz, nr), dtype=torch.float32, device=dev)
    r, z, p, Ap = vecs.unbind(0)
    if pcr is None:
        z = r                         # identity form: z aliases r
    nparts = lib.hf_cg_nparts(nz, nr)
    parts = torch.empty((4, nparts), dtype=torch.float64, device=dev)
    state = torch.empty(8, dtype=torch.float64, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    stream = _stream()
    args = (_ptr(A), A.shape[0], _ptr(sm), _ptr(b), _ptr(x0), _ptr(rtol_t),
            _ptr(pcr), lr, _ptr(pcr_z), lz, _ptr(x), _ptr(r), _ptr(z),
            _ptr(p), _ptr(Ap), _ptr(parts), nparts, _ptr(state), nz, nr,
            int(maxiter), int(rtol_wrt == "r0"), _counts_ptr(), stream)

    cg_tol.launches += 1
    form = ("launches_adi" if pcr_z is not None else
            "launches_rline" if pcr is not None else "launches_identity")
    setattr(cg_tol, form, getattr(cg_tol, form) + 1)
    _check(lib.hf_cg_tol_start(*args), "cg_tol start")
    done = state.view(torch.int32)[11]
    launched = 0
    while launched < maxiter:
        n = min(CHECK_EVERY, maxiter - launched)
        _check(lib.hf_cg_tol_iterate(*args, n), "cg_tol iterate")
        launched += n
        if done.item():
            break
    _check(lib.hf_cg_tol_finish(_ptr(x), _ptr(iters), _ptr(state), nz * nr,
                                _counts_ptr(), stream), "cg_tol finish")
    return x, iters


cg_tol.launches = 0
cg_tol.launches_identity = 0
cg_tol.launches_rline = 0
cg_tol.launches_adi = 0


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
