"""Batched CG for coefficient sweeps: the CUDA kernels (``csrc/sweep_cg.cu``)
and their plain PyTorch versions.

Lane b of a batch solves sm_b·(A0 + dk_b·Kv)·sm_b y = b_b: A0 and Kv are
(7|9, Nz, Nr) stencils shared by every lane, dks (B,) the per-lane
coefficient shifts, sm = rsqrt(diag)·free per lane, and b, x0 vanish at
constrained dofs. With ``Kv=None`` (and ``dks=None``) every lane solves with
A0 alone, and ``sm`` may be one (Nz, Nr) plane shared by the lanes: the
recording sweeps' mass projection (the Kv-free form). :func:`cg_batched_tol`
runs each lane to its own tolerance (‖r‖ ≤ rtol_b·‖b_b‖, or ·‖r0_b‖),
unpreconditioned, with the r-line PCR block-Jacobi solve R, with the
split-additive ADI solve R r + Z r − r (R and the z-line solve Z), or
adaptively: ADI in the lanes whose flag is set, r-line in the others;
:func:`cg_batched` runs every lane a fixed number of iterations. A tensor on
the CPU goes to the plain version; a CUDA tensor goes to the kernel, or the
call raises. The kernels replace heatflow_tpu/ops/pallas_cg.py:
_sweep_cg_tol_kernel (identity, r-line, ADI, adaptive and has_kv=False
forms, each with the standard or the merged-dot recurrence) and
_sweep_cg_kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from heatflow_tpu_torch.ops.cg import _dot, _lane, pcg_fixed
from heatflow_tpu_torch.ops import cuda_cg
from heatflow_tpu_torch.ops.cuda_cg import (_check, _check_rtol_wrt,
                                            _on_cpu, _ptr, _require, _stream)
from heatflow_tpu_torch.ops.linesolve import (line_couplings, pcr_apply,
                                              pcr_factor)
from heatflow_tpu_torch.ops.stencil import apply_combined, offsets_for
from heatflow_tpu_torch.utils import span

CHECK_EVERY = 8   # iterations enqueued between two host reads of the number
                  # of running lanes; the iterates and the counts do not
                  # depend on it

PHASES = ("init", "stencil_dot", "update", "pcr_r", "p_update", "compact",
          "finish", "init_no_kv", "stencil_dot_no_kv", "pcr_z", "merged_w",
          "merged_w_no_kv", "pq_update", "pcr_r_update")
# phase kernel launches, counted by the C host code where it launches them
_phase_counts = np.zeros(len(PHASES), dtype=np.int64)
_STATE_WORDS = 6   # float64 words of one lane's solve state
_MAX_LANES = 65535   # the CUDA grid's y extent
TILE = (16, 32)    # rows and columns of a tile of the operator passes
                   # (ks_apply), one partial sum a (lane, tile)


def _counts_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(_phase_counts.ctypes.data)


def _library():
    """The built kernels' library, checked against this module's mirror of
    the per-lane state layout."""
    from heatflow_tpu_torch.ops._build import load_library
    lib = load_library()
    if (lib.hf_sweep_num_phases() != len(PHASES)
            or lib.hf_sweep_state_bytes() != 8 * _STATE_WORDS
            or lib.hf_sweep_tiles2d(TILE[0] + 1, TILE[1] + 1) != 4):
        raise RuntimeError("csrc/sweep_cg.cu and ops/cuda_sweep.py disagree "
                           "on the solve-state or tile layout")
    return lib


def tiles2d(nz: int, nr: int) -> int:
    """Tiles of the operator passes on an (nz, nr) grid, row-major."""
    return -(-nz // TILE[0]) * -(-nr // TILE[1])


def phase_launches() -> dict[str, int]:
    """Launches of each phase kernel since the last :func:`reset_counters`."""
    return {name: int(n) for name, n in zip(PHASES, _phase_counts)}


def reset_counters() -> None:
    _phase_counts[:] = 0
    for name in ("launches", "launches_identity", "launches_rline",
                 "launches_adi", "launches_adaptive", "launches_no_kv",
                 "launches_merged"):
        setattr(cg_batched_tol, name, 0)
    cg_batched_tol.iteration_launches = {}
    cg_batched.launches = 0


def launches_per_iteration() -> dict[str, float]:
    """Phase-kernel launches an enqueued CG iteration, by solve form
    ('identity', 'rline', 'adi', 'adaptive', 'no_kv', 'fixed', each with
    '_merged' for the merged-dot recurrence), since the last
    :func:`reset_counters`."""
    return {form: n / its for form, (n, its)
            in cg_batched_tol.iteration_launches.items() if its}


_SCALARS = ("rz", "rr", "stop2", "alpha", "beta")   # float64 words 0-4
FINALIZE_MODES = ("init", "alpha", "beta")


def pack_state(B: int, device, **fields) -> torch.Tensor:
    """A (B, 6) float64 tensor in the kernels' per-lane state layout: the
    scalars rz, rr, stop2, alpha, beta, then the int32 count k and done
    flag (int32 words 10 and 11). Fields not given are 0."""
    st = torch.zeros((B, _STATE_WORDS), dtype=torch.float64, device=device)
    for i, name in enumerate(_SCALARS):
        if name in fields:
            st[:, i] = torch.as_tensor(fields[name], dtype=torch.float64,
                                       device=device)
    ints = st.view(torch.int32)
    for w, name in ((10, "k"), (11, "done")):
        if name in fields:
            ints[:, w] = torch.as_tensor(fields[name], dtype=torch.int32,
                                         device=device)
    return st


def unpack_state(st: torch.Tensor) -> dict:
    """The fields of a per-lane state tensor (see :func:`pack_state`)."""
    ints = st.view(torch.int32)
    out = {name: st[:, i] for i, name in enumerate(_SCALARS)}
    out.update(k=ints[:, 10], done=ints[:, 11])
    return out


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def rline_reference(A0, Kv, dks, sm, axis: int = -1):
    """The r-line (``axis=-1``) or z-line (``axis=-2``) PCR block-Jacobi
    solve of every lane's scaled operator, factored here (unfolded levels,
    as the kernels factor them), masked to the free dofs."""
    l, u = line_couplings(A0, sm, axis, Kv=Kv, dk=dks)
    levels = pcr_factor(l, u, axis=axis)
    free = (sm != 0).to(sm.dtype)
    return lambda r: pcr_apply(levels, r, axis=axis) * free


def _preconditioner(A0, Kv, dks, sm, rline, adi, adi_flags):
    """The plain preconditioner of a form: identity; the r-line solve R;
    the split-additive ADI solve (R r + Z r − r)·free (Z the z-line solve,
    the doubly counted identity taken off, in the kernels' order); or,
    with ``adi_flags``, ADI in the flagged lanes and R in the others."""
    if not (rline or adi or adi_flags is not None):
        return lambda r: r
    R = rline_reference(A0, Kv, dks, sm)
    if rline:
        return R
    Z = rline_reference(A0, Kv, dks, sm, axis=-2)
    free = (sm != 0).to(sm.dtype)
    on = None if adi_flags is None else _lane(adi_flags != 0)

    def pre(r):
        zr = R(r)
        z = (zr + Z(r) - r) * free
        return z if on is None else torch.where(on, z, zr)
    return pre


def stencil_dot_reference(A0, Kv, dks, sm, p, state=None):
    """(sm·A_b·(sm·p), ⟨p, sm·A_b·(sm·p)⟩ per lane) — the plain stencil-and-
    dot phase; with a per-lane ``state`` the lanes it marks done read 0 and
    the others' alpha tail gives the new state, returned last."""
    Ap = sm * apply_combined(A0, Kv, dks, sm * p)
    out = _skip_done(state, Ap, _dot(p.double(), Ap.double()))
    if state is None:
        return out
    return out + (tail_reference(state, _parts4(len(p), p.device,
                                                pap=out[1]),
                                 "alpha", rline=False, maxiter=0),)


def pcr_r_reference(A0, Kv, dks, sm, r, state=None, rr=None, bb=None,
                    rtol=0.0, *, maxiter: int = 0, rtol_wrt: str = "b",
                    fixed: bool = False):
    """(z, ⟨r, z⟩ per lane) for the r-line preconditioner — the plain PCR
    phase. With a per-lane ``state`` (and ⟨r, r⟩ ``rr``, ⟨b, b⟩ ``bb`` per
    lane), the start of an r-line solve: the lanes the state marks done
    read 0 and keep their state, the others get the r-line form's first
    scalars (tail mode 'init'); the new state is returned last."""
    z = rline_reference(A0, Kv, dks, sm)(r)
    out = _skip_done(state, z, _dot(r.double(), z.double()))
    if state is None:
        return out
    run = torch.nonzero(unpack_state(state)["done"] == 0).flatten()
    return out + (tail_reference(
        state, _parts4(len(r), r.device, rr=rr, rz=out[1], bb=bb), "init",
        rtol, lanes=run, rline=True, maxiter=maxiter, rtol_wrt=rtol_wrt,
        fixed=fixed),)


def pcr_z_reference(A0, Kv, dks, sm, r, z_r):
    """(z = (R r + Z r − r)·free, ⟨r, z⟩ per lane) given the r-line solve
    ``z_r`` = R r — the plain z-line phase of the ADI form."""
    z = (z_r + rline_reference(A0, Kv, dks, sm, axis=-2)(r) - r) \
        * (sm != 0).to(sm.dtype)
    return z, _dot(r.double(), z.double())


def pcr_r_update_reference(A0, Kv, dks, sm, x, r, p, Ap, alpha, *,
                           adi: bool = False):
    """(x + α·p, r' = r − α·Ap, z = M⁻¹ r', ⟨r', r'⟩, ⟨r', z⟩ per lane) —
    the plain fused update and preconditioner phase (``ks_pcr_r<true>``, and
    with ``adi`` the z-line phase after it): :func:`update_reference`, then
    :func:`pcr_r_reference` (and :func:`pcr_z_reference`)."""
    x_n, r_n, rr = update_reference(x, r, p, Ap, alpha)
    z, rz = pcr_r_reference(A0, Kv, dks, sm, r_n)
    if adi:
        z, rz = pcr_z_reference(A0, Kv, dks, sm, r_n, z)
    return x_n, r_n, z, rr, rz


def pcr_r_update_state_reference(A0, Kv, dks, sm, x, r, p, Ap, state, *,
                                 adi: bool = False, maxiter: int = 0,
                                 fixed: bool = False, tail: bool = True):
    """:func:`pcr_r_update_reference` with α from each lane's state, a lane
    the state marks done left as it is (z and its dots 0), and with
    ``tail`` the beta tail: (x', r', z, ⟨r', r'⟩, ⟨r', z⟩, new state)."""
    f = unpack_state(state)
    out = pcr_r_update_reference(A0, Kv, dks, sm, x, r, p, Ap, f["alpha"],
                                 adi=adi)
    run = _lane(f["done"] == 0)
    x_n, r_n = torch.where(run, out[0], x), torch.where(run, out[1], r)
    z, rr, rz = _skip_done(state, *out[2:])
    st = (tail_reference(state, _parts4(len(x), x.device, rr=rr, rz=rz),
                         "beta", rline=True, maxiter=maxiter, fixed=fixed)
          if tail else state.clone())
    return x_n, r_n, z, rr, rz, st


def apply_blocked_reference(A0, Kv, dks, sm, v, lanes=None):
    """The lane-blocked operator pass as its kernel tiles it: for the
    entries of ``lanes`` (default every lane) the coefficients A0 + dk·Kv,
    sv = sm·v over the grid with a zero halo, and s = sm·A_b·sv at every
    point, in the offset order of ``ops/stencil.py``. Returns (s (B, Nz,
    Nr), zero on the lanes not listed, and the partial sums of ⟨v, s⟩
    (B, tiles2d) in float64, one a (lane, tile) of :data:`TILE`)."""
    B, nz, nr = v.shape
    lanes = (torch.arange(B) if lanes is None
             else torch.as_tensor(lanes).long())
    out = torch.zeros_like(v)
    ty, tx = TILE
    nty, ntx = -(-nz // ty), -(-nr // tx)
    parts = torch.zeros((B, nty * ntx), dtype=torch.float64)
    smg = sm[lanes] if sm.ndim == 3 else sm.expand(len(lanes), nz, nr)
    sv = torch.nn.functional.pad(smg * v[lanes], (1, 1, 1, 1))
    coef = (A0[None] if Kv is None
            else A0[None] + dks[lanes][:, None, None, None] * Kv[None])
    acc = None
    for k, (di, dj) in enumerate(offsets_for(A0.shape[0])):
        term = coef[:, k] * sv[:, 1 + di:1 + di + nz, 1 + dj:1 + dj + nr]
        acc = term if acc is None else acc + term
    s = smg * acc
    out[lanes] = s
    prod = torch.nn.functional.pad((v[lanes] * s).double(),
                                   (0, ntx * tx - nr, 0, nty * ty - nz))
    parts[lanes] = prod.reshape(len(lanes), nty, ty, ntx, tx) \
        .sum(dim=(2, 4)).reshape(len(lanes), -1)
    return out, parts


TAIL_MODES = ("init", "alpha", "beta", "merged_first", "merged")


def tail_reference(state, parts, mode: str, rtol=0.0, *, lanes=None,
                   flags=None, flag_sel: int = -1, rline: bool,
                   maxiter: int, rtol_wrt: str = "b",
                   fixed: bool = False) -> torch.Tensor:
    """The per-lane tail of a phase kernel on a state (B, 6) and partial
    sums parts (4, B, n): the lanes the kernel works on (those of ``lanes``,
    default every lane; a done lane only in mode 'init'; with ``flag_sel``
    >= 0 only the lanes whose flag is (flag_sel != 0)) get the scalar rule
    of :func:`finalize_reference` ('init', 'alpha', 'beta') or of
    :func:`finalize_merged_reference` ('merged_first', 'merged'); the other
    lanes are left as they are. Returns the new state."""
    if mode not in TAIL_MODES:
        raise ValueError(f"tail mode must be one of {TAIL_MODES}")
    B = state.shape[0]
    on = torch.zeros(B, dtype=torch.bool, device=state.device)
    on[torch.arange(B) if lanes is None else torch.as_tensor(lanes).long()] \
        = True
    if mode not in ("init", "merged_first"):
        on &= unpack_state(state)["done"] == 0
    if flag_sel >= 0:
        on &= (torch.as_tensor(flags, device=state.device) != 0) \
            == bool(flag_sel)
    if mode.startswith("merged"):
        new = finalize_merged_reference(state, parts, mode == "merged_first",
                                        rtol, preconditioned=rline,
                                        maxiter=maxiter, rtol_wrt=rtol_wrt)
    else:
        new = finalize_reference(state, parts, mode, rtol, rline=rline,
                                 maxiter=maxiter, rtol_wrt=rtol_wrt,
                                 fixed=fixed)
    return torch.where(on[:, None], new, state)


def _parts4(B, device, pap=None, rr=None, rz=None, bb=None) -> torch.Tensor:
    """(4, B, 1) partial sums of pAp, rr, rz, bb from per-lane sums."""
    zero = torch.zeros(B, dtype=torch.float64, device=device)
    return torch.stack([zero if t is None else t.double()
                        for t in (pap, rr, rz, bb)])[..., None]


def _skip_done(state, *outs):
    """The plain phase's outputs with the lanes that a state marks done
    zeroed (fields) or set to 0 (sums): the kernels skip those lanes."""
    if state is None:
        return outs
    run = unpack_state(state)["done"] == 0
    return tuple(torch.where(_lane(run) if o.ndim == 3 else run, o,
                             torch.zeros_like(o)) for o in outs)


def init_reference(A0, Kv, dks, sm, b, x0, state=None, rtol=0.0, *,
                   maxiter: int = 0, rtol_wrt: str = "b",
                   fixed: bool = False):
    """(x = x0, r = b − sm·A_b·(sm·x0), ⟨r, r⟩, ⟨b, b⟩ per lane) — the plain
    first-residual phase; with a per-lane ``state`` also the identity
    form's first scalars (tail mode 'init'), the new state returned last."""
    r = b - sm * apply_combined(A0, Kv, dks, sm * x0)
    out = (x0.clone(), r, _dot(r.double(), r.double()),
           _dot(b.double(), b.double()))
    if state is None:
        return out
    return out + (tail_reference(
        state, _parts4(len(b), b.device, rr=out[2], bb=out[3]), "init", rtol,
        rline=False, maxiter=maxiter, rtol_wrt=rtol_wrt, fixed=fixed),)


def update_beta_reference(x, r, p, Ap, state, *, maxiter: int,
                          fixed: bool = False):
    """(x', r', ⟨r', r'⟩, new state): :func:`update_reference` with α from
    each lane's state, then the identity form's beta tail; a lane the state
    marks done is left as it is (its dot 0)."""
    f = unpack_state(state)
    x_n, r_n, rr = update_reference(x, r, p, Ap, f["alpha"])
    run = _lane(f["done"] == 0)
    (rr,) = _skip_done(state, rr)
    return (torch.where(run, x_n, x), torch.where(run, r_n, r), rr,
            tail_reference(state, _parts4(len(x), x.device, rr=rr), "beta",
                           rline=False, maxiter=maxiter, fixed=fixed))


def update_reference(x, r, p, Ap, alpha):
    """(x + α·p, r − α·Ap, ⟨r', r'⟩ per lane), α (B,) rounded to the fields'
    dtype — the plain update phase."""
    a = _lane(alpha.to(x.dtype))
    r_n = r - a * Ap
    return x + a * p, r_n, _dot(r_n.double(), r_n.double())


def p_update_reference(p, z, beta):
    """z + β·p per lane, β (B,) rounded to the fields' dtype."""
    return z + _lane(beta.to(p.dtype)) * p


def finalize_reference(state, parts, mode: str, rtol=0.0, *, rline: bool,
                       maxiter: int, rtol_wrt: str = "b",
                       fixed: bool = False) -> torch.Tensor:
    """The scalar phase on a per-lane state (B, 6) and partial sums parts
    (4, B, n) of ⟨p, Ap⟩, ⟨r, r⟩, ⟨r, z⟩, ⟨b, b⟩: ``'init'`` sets the
    first step's scalars and stop², ``'alpha'`` α = rz / pAp, ``'beta'``
    β = rz' / rz, the count and the stop test; with the guards pAp == 0 → 1,
    rz == 0 → 1. A lane already done is left as it is (except by 'init').
    Returns the new state."""
    pap, rr, rz, bb = parts.double().sum(dim=-1)
    if not rline:
        rz = rr
    old = unpack_state(state)
    new = dict(old)
    one = torch.ones_like(rr)
    if mode == "alpha":
        new["alpha"] = old["rz"] / torch.where(pap != 0, pap, one)
    elif mode in ("init", "beta"):
        rr_n = rr if rline else rz
        k = (torch.zeros_like(old["k"]) if mode == "init"
             else old["k"] + 1)
        if mode == "init":
            rt = (torch.zeros_like(rr) if fixed else _rtol_lanes(
                rtol, len(rr), torch.float32, rr.device).double())
            stop2 = rt * rt * (rr_n if rtol_wrt == "r0" else bb)
            new.update(stop2=stop2, alpha=torch.zeros_like(rr),
                       beta=torch.zeros_like(rr))
        else:
            stop2 = old["stop2"]
            new["beta"] = rz / torch.where(old["rz"] != 0, old["rz"], one)
        run = k < maxiter if fixed else (k < maxiter) & (rr_n > stop2)
        new.update(rz=rz, rr=rr_n, k=k, done=(~run).to(torch.int32))
    else:
        raise ValueError(f"finalize mode must be one of {FINALIZE_MODES}")
    out = pack_state(len(rr), state.device, **new)
    if mode != "init":
        out = torch.where((old["done"] != 0)[:, None], state, out)
    return out


def compact_reference(state) -> torch.Tensor:
    """The lanes whose done flag is clear, in order (int32)."""
    return torch.nonzero(unpack_state(state)["done"] == 0).flatten() \
        .to(torch.int32)


def finish_reference(x, state, poison: bool = True):
    """(x with NaN over every lane whose ‖r‖² is not finite when
    ``poison``, iters = each lane's count)."""
    f = unpack_state(state)
    if poison:
        x = torch.where(_lane(torch.isfinite(f["rr"])), x,
                        torch.full_like(x, float("nan")))
    return x, f["k"].clone()


def _rtol_lanes(rtol, B: int, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(rtol, dtype=dtype, device=device).reshape(-1)
    if t.numel() not in (1, B):
        raise ValueError(f"rtol must be a scalar or ({B},), got "
                         f"{t.numel()} values")
    return t.expand(B)


def _check_form(rline: bool, adi: bool, adi_flags) -> None:
    if rline and adi:
        raise ValueError("rline and adi are mutually exclusive (adi already "
                         "contains the r-line solve)")
    if adi_flags is not None and (rline or adi):
        raise ValueError("adi_flags (the per-lane adaptive r-line/ADI "
                         "switch) replaces the static rline/adi flags")


def cg_batched_tol_reference(A0, Kv, dks, sm, b, x0, rtol, *,
                             maxiter: int = 4000, rtol_wrt: str = "b",
                             rline: bool = False, adi: bool = False,
                             adi_flags=None, merged: bool | None = None):
    """Plain PyTorch version of the tolerance kernel, in the inputs' dtype:
    the standard PCG recurrence of the TPU kernel per lane (with ``merged``
    its Chronopoulos–Gear recurrence), with its guards
    (pAp == 0 → 1, rz == 0 → 1), its stop rule (while k < maxiter and
    rr > stop2, rr = ‖r‖² when preconditioned and ⟨r, z⟩ otherwise), a lane
    frozen once it stops, and x = NaN over a lane whose rr is not finite.
    ``adi`` preconditions every lane with the ADI solve, ``adi_flags`` (B,)
    the flagged lanes (r-line in the others). Returns (x, iters) with iters
    (B,) int32."""
    _check_rtol_wrt(rtol_wrt)
    _check_form(rline, adi, adi_flags)
    B = b.shape[0]
    apply_op = lambda y: sm * apply_combined(A0, Kv, dks, sm * y)
    precond = _preconditioner(A0, Kv, dks, sm, rline, adi, adi_flags)
    rline = rline or adi or adi_flags is not None     # preconditioned
    rt = _rtol_lanes(rtol, B, b.dtype, b.device)

    if merged is None:
        merged = cuda_cg.MERGED_DEFAULT
    x = x0
    r = b - apply_op(x)
    k = torch.zeros(B, dtype=torch.int32, device=b.device)
    if merged:
        return _merged_reference(apply_op, precond, b, x, r, rt, k, maxiter,
                                 rtol_wrt, rline)
    z = precond(r)
    p = z
    rz = _dot(r, z)
    rr = _dot(r, r) if rline else rz
    ref2 = rr if rtol_wrt == "r0" else _dot(b, b)
    stop2 = rt * rt * ref2
    one = torch.ones_like(rz)
    while True:
        active = (k < maxiter) & (rr > stop2)
        if not bool(active.any()):
            break
        Ap = apply_op(p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp != 0, pAp, one)
        x_n = x + _lane(alpha) * p
        r_n = r - _lane(alpha) * Ap
        z_n = precond(r_n)
        rz_n = _dot(r_n, z_n)
        beta = rz_n / torch.where(rz != 0, rz, one)
        p_n = z_n + _lane(beta) * p
        rr_n = _dot(r_n, r_n) if rline else rz_n
        am = _lane(active)
        x, r, p = (torch.where(am, x_n, x), torch.where(am, r_n, r),
                   torch.where(am, p_n, p))
        rz = torch.where(active, rz_n, rz)
        rr = torch.where(active, rr_n, rr)
        k = k + active.to(torch.int32)
    x = torch.where(_lane(torch.isfinite(rr)), x,
                    torch.full_like(x, float("nan")))
    return x, k


def _merged_reference(apply_op, precond, b, x, r, rt, k, maxiter, rtol_wrt,
                      preconditioned):
    """The Chronopoulos–Gear loop per lane on the first residual ``r``, a
    lane frozen once it stops: (x, iters)."""
    guard = lambda v: torch.where(v != 0, v, torch.ones_like(v))
    rr = _dot(r, r)
    stop2 = rt * rt * (rr if rtol_wrt == "r0" else _dot(b, b))
    u = precond(r)
    w = apply_op(u)
    gamma = _dot(r, u)
    alpha = gamma / guard(_dot(w, u))
    p, q = u, w
    while True:
        active = (k < maxiter) & (rr > stop2)
        if not bool(active.any()):
            break
        x_n = x + _lane(alpha) * p
        r_n = r - _lane(alpha) * q
        u = precond(r_n)
        w = apply_op(u)
        gamma_n = _dot(r_n, u)
        delta = _dot(w, u)
        rr_n = _dot(r_n, r_n) if preconditioned else gamma_n
        beta = gamma_n / guard(gamma)
        denom = delta - beta * gamma_n / guard(alpha)
        alpha_n = gamma_n / guard(denom)
        p_n = u + _lane(beta) * p
        q_n = w + _lane(beta) * q
        am = _lane(active)
        x, r, p, q = (torch.where(am, x_n, x), torch.where(am, r_n, r),
                      torch.where(am, p_n, p), torch.where(am, q_n, q))
        alpha = torch.where(active, alpha_n, alpha)
        gamma = torch.where(active, gamma_n, gamma)
        rr = torch.where(active, rr_n, rr)
        k = k + active.to(torch.int32)
    x = torch.where(_lane(torch.isfinite(rr)), x,
                    torch.full_like(x, float("nan")))
    return x, k


def merged_w_reference(A0, Kv, dks, sm, u, r, state=None, *,
                       preconditioned: bool = True, maxiter: int = 0):
    """(w = sm·A_b·(sm·u), δ = ⟨w, u⟩, ⟨r, r⟩, γ = ⟨r, u⟩ per lane) — the
    plain merged-dot pass; the sums are float64. With a per-lane ``state``
    the lanes it marks done read 0 and the others' merged tail (a later
    step) gives the new state, returned last."""
    w = sm * apply_combined(A0, Kv, dks, sm * u)
    d = lambda a, c: _dot(a.double(), c.double())
    out = _skip_done(state, w, d(w, u), d(r, r), d(r, u))
    if state is None:
        return out
    return out + (tail_reference(
        state, _parts4(len(u), u.device, pap=out[1], rr=out[2], rz=out[3]),
        "merged", rline=preconditioned, maxiter=maxiter),)


def pq_update_reference(p, q, u, w, beta):
    """(u + β·p, w + β·q) per lane, β (B,) rounded to the fields' dtype."""
    bl = _lane(beta.to(p.dtype))
    return u + bl * p, w + bl * q


def finalize_merged_reference(state, parts, first: bool, rtol=0.0, *,
                              preconditioned: bool, maxiter: int,
                              rtol_wrt: str = "b") -> torch.Tensor:
    """The merged recurrence's scalar phase on a per-lane state (B, 6) and
    partial sums parts (4, B, n) of δ, ⟨r, r⟩, γ, ⟨b, b⟩: the first call
    sets α = γ/δ, stop² and the first stop test; later calls β = γ'/γ and
    α' = γ'/(δ − βγ'/α), the count and the stop test, each divisor 0 → 1.
    A lane already done is left as it is (except by the first call)."""
    delta, rr, gamma, bb = parts.double().sum(dim=-1)
    old = unpack_state(state)
    guard = lambda v: torch.where(v != 0, v, torch.ones_like(v))
    new = dict(old)
    if first:
        rt = _rtol_lanes(rtol, len(rr), torch.float32, rr.device).double()
        new.update(rz=gamma, rr=rr,
                   stop2=rt * rt * (rr if rtol_wrt == "r0" else bb),
                   alpha=gamma / guard(delta), beta=torch.zeros_like(rr),
                   k=torch.zeros_like(old["k"]))
    else:
        beta = gamma / guard(old["rz"])
        denom = delta - beta * gamma / guard(old["alpha"])
        new.update(alpha=gamma / guard(denom), beta=beta, rz=gamma,
                   rr=rr if preconditioned else gamma, k=old["k"] + 1)
    run = (new["k"] < maxiter) & (new["rr"] > new["stop2"])
    new["done"] = (~run).to(torch.int32)
    out = pack_state(len(rr), state.device, **new)
    if not first:
        out = torch.where((old["done"] != 0)[:, None], state, out)
    return out


def cg_batched_reference(A0, Kv, dks, sm, b, x0, *, iters: int = 100):
    """Plain PyTorch version of the fixed-iteration kernel: ``pcg_fixed`` on
    every lane's scaled operator, unpreconditioned."""
    return pcg_fixed(lambda y: sm * apply_combined(A0, Kv, dks, sm * y), b,
                     x0, iters=iters).x


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

def _check_batch(A0, Kv, dks, sm, fields):
    """(B, nz, nr) after checking every operand of a batched call: B lanes
    of (Nz, Nr) fields; sm one plane a lane, or one (Nz, Nr) plane shared by
    the lanes; Kv and dks both given, or both None."""
    ref = sm if sm.ndim == 3 or not fields else next(iter(fields.values()))
    if ref.ndim != 3:
        raise ValueError(f"sm must be (B, Nz, Nr), or (Nz, Nr) with (B, Nz, "
                         f"Nr) fields; got {tuple(sm.shape)}")
    B, nz, nr = ref.shape
    if not 1 <= B <= _MAX_LANES:
        raise ValueError(f"batch of {B} lanes: the kernel takes 1.."
                         f"{_MAX_LANES}")
    dev = ref.device
    if A0.ndim != 3 or A0.shape[0] not in (7, 9):
        raise ValueError(f"A0 must be (7|9, Nz, Nr), got {tuple(A0.shape)}")
    _require(A0, "A0", (A0.shape[0], nz, nr), dev)
    if (Kv is None) != (dks is None):
        raise ValueError("Kv and dks go together: give both or neither")
    if Kv is not None:
        _require(Kv, "Kv", (A0.shape[0], nz, nr), dev)
        _require(dks, "dks", (B,), dev)
    _require(sm, "sm", (B, nz, nr) if sm.ndim == 3 else (nz, nr), dev)
    for name, t in fields.items():
        _require(t, name, (B, nz, nr), dev)
    return B, nz, nr


class _Solve:
    """Device buffers and the C argument list of one batched solve."""

    def __init__(self, lib, A0, Kv, dks, sm, b, x0, rtol_t, *, maxiter,
                 wrt_r0, rline, fixed, adi=0, flags=None, merged=False):
        B, nz, nr = b.shape
        dev = b.device
        self.lib, self.B, self.nz, self.nr = lib, B, nz, nr
        self.x = torch.empty_like(b)
        vecs = torch.empty((3 + int(rline) + int(merged), B, nz, nr),
                           dtype=torch.float32, device=dev)
        r, p, Ap = vecs[0], vecs[1], vecs[2]
        z = vecs[3] if rline else r       # identity form: z aliases r
        # merged-dot: q = A p takes the Ap plane, w = A u one more
        q, w = (Ap, vecs[-1]) if merged else (None, None)
        nparts = lib.hf_sweep_nparts(nz, nr)
        self.parts = torch.empty((4, B, nparts), dtype=torch.float64,
                                 device=dev)
        self.state = torch.empty((B, _STATE_WORDS), dtype=torch.float64,
                                 device=dev)
        self.lanes = torch.arange(B, dtype=torch.int32, device=dev)
        self.count = torch.empty((), dtype=torch.int32, device=dev)
        self.iters = torch.empty(B, dtype=torch.int32, device=dev)
        self.tickets = torch.empty(B, dtype=torch.int32, device=dev)
        self.stream = _stream()
        self._keep = (vecs, rtol_t, flags)
        self.args = (_ptr(A0), _ptr(Kv), A0.shape[0], _ptr(dks), _ptr(sm),
                     int(sm.ndim == 3), _ptr(b), _ptr(x0), _ptr(rtol_t),
                     _ptr(self.x), _ptr(r),
                     _ptr(z), _ptr(p), _ptr(Ap), _ptr(self.parts), nparts,
                     _ptr(self.state), _ptr(self.lanes), B, nz, nr,
                     int(maxiter), int(wrt_r0), int(rline), int(fixed),
                     int(adi), _ptr(flags), _counts_ptr(), self.stream,
                     int(merged), _ptr(q), _ptr(w), _ptr(self.tickets))

    def start(self):
        _check(self.lib.hf_sweep_start(*self.args), "sweep start")

    def iterate(self, n_iter: int, n_lanes: int, form: str):
        """Enqueue n_iter iterations; their launches count under ``form``
        (see :func:`launches_per_iteration`)."""
        with span("k2.iterate"):
            before = int(_phase_counts.sum())
            _check(self.lib.hf_sweep_iterate(*self.args, n_iter, n_lanes),
                   "sweep iterate")
            acc = cg_batched_tol.iteration_launches.setdefault(form, [0, 0])
            acc[0] += int(_phase_counts.sum()) - before
            acc[1] += n_iter

    def running(self) -> int:
        """Compact the running lanes to the front of the lane list; returns
        their number (one host read)."""
        with span("k2.check"):
            _check(self.lib.hf_sweep_compact(_ptr(self.state), self.B,
                                             _ptr(self.lanes),
                                             _ptr(self.count), _counts_ptr(),
                                             self.stream), "sweep compact")
            return int(self.count.item())

    def finish(self, poison: bool):
        _check(self.lib.hf_sweep_finish(_ptr(self.x), _ptr(self.iters),
                                        _ptr(self.state), self.B, self.nz,
                                        self.nr, int(poison), _counts_ptr(),
                                        self.stream), "sweep finish")


def cg_batched_tol(A0: torch.Tensor, Kv: torch.Tensor | None,
                   dks: torch.Tensor | None, sm: torch.Tensor,
                   b: torch.Tensor, x0: torch.Tensor, rtol, *,
                   maxiter: int = 4000, rtol_wrt: str = "b",
                   rline: bool = False, adi: bool = False,
                   adi_flags: torch.Tensor | None = None,
                   merged: bool | None = None):
    """Solve every lane to its tolerance; returns (x (B, Nz, Nr), iters (B,)
    int32 on the inputs' device). ``rtol`` is a float or a (B,) tensor (the
    refinement's per-lane guard: a lane at rtol ≥ 1 stops at its first
    check). ``Kv=None, dks=None``: the Kv-free form (A0 alone; ``sm`` may be
    a shared (Nz, Nr) plane). ``rline``: the r-line solve; ``adi``: the ADI
    solve; ``adi_flags`` (B,) int32, the adaptive form: ADI in the lanes
    whose flag is nonzero, r-line in the others (read on the device).
    ``merged`` (default ``cuda_cg.MERGED_DEFAULT``, read at call time): the
    merged-dot recurrence, tolerance-equal to the standard one. CPU
    tensors take the plain version; CUDA float32 tensors the kernel."""
    _check_rtol_wrt(rtol_wrt)
    _check_form(rline, adi, adi_flags)
    if merged is None:
        merged = cuda_cg.MERGED_DEFAULT
    if _on_cpu(A0, Kv, dks, sm, b, x0, adi_flags):
        return cg_batched_tol_reference(A0, Kv, dks, sm, b, x0, rtol,
                                        maxiter=maxiter, rtol_wrt=rtol_wrt,
                                        rline=rline, adi=adi,
                                        adi_flags=adi_flags, merged=merged)
    with span("k2.solve"):
        lib = _library()
        B, _, _ = _check_batch(A0, Kv, dks, sm, {"b": b, "x0": x0})
        rtol_t = _rtol_lanes(rtol, B, torch.float32, b.device).contiguous()
        flags = None
        if adi_flags is not None:
            if (adi_flags.shape != (B,) or adi_flags.device != b.device):
                raise ValueError(f"adi_flags must be ({B},) on {b.device}")
            flags = adi_flags.to(torch.int32).contiguous()
        solve = _Solve(lib, A0, Kv, dks, sm, b, x0, rtol_t, maxiter=maxiter,
                       wrt_r0=rtol_wrt == "r0",
                       rline=rline or adi or flags is not None, fixed=False,
                       adi=2 if flags is not None else int(adi), flags=flags,
                       merged=bool(merged))
        cg_batched_tol.launches += 1
        if merged:
            cg_batched_tol.launches_merged += 1
        form = ("launches_no_kv" if Kv is None else
                "launches_adaptive" if flags is not None else
                "launches_adi" if adi else
                "launches_rline" if rline else "launches_identity")
        setattr(cg_batched_tol, form, getattr(cg_batched_tol, form) + 1)
        solve.start()
        n_lanes = solve.running()
        launched = 0
        tag = form[len("launches_"):] + ("_merged" if merged else "")
        while n_lanes and launched < maxiter:
            n = min(CHECK_EVERY, maxiter - launched)
            solve.iterate(n, n_lanes, tag)
            launched += n
            n_lanes = solve.running()
        solve.finish(poison=True)
        return solve.x, solve.iters


cg_batched_tol.launches = 0
cg_batched_tol.launches_identity = 0
cg_batched_tol.launches_rline = 0
cg_batched_tol.launches_adi = 0
cg_batched_tol.launches_adaptive = 0
cg_batched_tol.launches_no_kv = 0
cg_batched_tol.launches_merged = 0
cg_batched_tol.iteration_launches = {}


def cg_batched(A0: torch.Tensor, Kv: torch.Tensor, dks: torch.Tensor,
               sm: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, *,
               iters: int = 100) -> torch.Tensor:
    """``iters`` CG iterations on every lane (no stop test, no freeze):
    the trajectory of ``pcg_fixed`` on each lane's scaled operator. CPU
    tensors take the plain version; CUDA float32 tensors the kernel."""
    if _on_cpu(A0, Kv, dks, sm, b, x0):
        return cg_batched_reference(A0, Kv, dks, sm, b, x0, iters=iters)
    lib = _library()
    B, _, _ = _check_batch(A0, Kv, dks, sm, {"b": b, "x0": x0})
    solve = _Solve(lib, A0, Kv, dks, sm, b, x0, None, maxiter=iters,
                   wrt_r0=False, rline=False, fixed=True)
    cg_batched.launches += 1
    solve.start()
    if iters > 0:
        solve.iterate(iters, B, "fixed")
    solve.finish(poison=False)
    return solve.x


cg_batched.launches = 0


def _phase_setup(fields: dict, A0=None, Kv=None, dks=None, sm=None):
    """(lib, B, nz, nr, nparts, lanes 0..B-1) after checking a phase's
    operands: the operator's where it reads one, else the fields alone."""
    lib = _library()
    first = next(iter(fields.values()))
    if A0 is not None:
        B, nz, nr = _check_batch(A0, Kv, dks, sm, fields)
    else:
        if first.ndim != 3:
            raise ValueError(f"fields must be (B, Nz, Nr), got "
                             f"{tuple(first.shape)}")
        B, nz, nr = first.shape
        for name, t in fields.items():
            _require(t, name, (B, nz, nr), first.device)
    lanes = torch.arange(B, dtype=torch.int32, device=first.device)
    return lib, B, nz, nr, lib.hf_sweep_nparts(nz, nr), lanes


def _check_state(state, device) -> int:
    """B after checking a per-lane state tensor (see :func:`pack_state`)."""
    if (state.ndim != 2 or state.shape[1] != _STATE_WORDS
            or state.dtype != torch.float64 or not state.is_contiguous()
            or state.device != device):
        raise ValueError(f"state must be a contiguous (B, {_STATE_WORDS}) "
                         f"float64 tensor on {device}")
    return state.shape[0]


def _parts(B, nparts, device) -> torch.Tensor:
    """Four zeroed partial-sum planes (pAp, rr, rz, bb) of B x nparts."""
    return torch.zeros((4, B, nparts), dtype=torch.float64, device=device)


def _tail_args(state, B, device):
    """(new state, tickets) of a phase with a tail: a copy of ``state``
    that the kernel updates and B zero tickets; (None, None) without."""
    if state is None:
        return None, None
    if _check_state(state, device) != B:
        raise ValueError(f"state has {state.shape[0]} lanes, the fields {B}")
    return state.clone(), torch.zeros(B, dtype=torch.int32, device=device)


def init(A0, Kv, dks, sm, b, x0, state=None, rtol=0.0, *, maxiter: int = 0,
         rtol_wrt: str = "b", fixed: bool = False):
    """The first-residual phase alone: (x, r, ⟨r, r⟩, ⟨b, b⟩ per lane) with
    r = b − sm·A_b·(sm·x0); the dots are float64. ``Kv=dks=None``: the
    Kv-free form. With a per-lane ``state``, also the identity form's tail
    (the first step's scalars, :func:`tail_reference` mode 'init'): the new
    state is returned last."""
    if _on_cpu(A0, Kv, dks, sm, b, x0):
        return init_reference(A0, Kv, dks, sm, b, x0, state, rtol,
                              maxiter=maxiter, rtol_wrt=rtol_wrt,
                              fixed=fixed)
    _check_rtol_wrt(rtol_wrt)
    lib, B, nz, nr, nparts, lanes = _phase_setup({"b": b, "x0": x0}, A0, Kv,
                                                 dks, sm)
    x, r = torch.empty_like(b), torch.empty_like(b)
    parts = _parts(B, nparts, b.device)
    st, tickets = _tail_args(state, B, b.device)
    rtol_t = _rtol_lanes(rtol, B, torch.float32, b.device).contiguous()
    _check(lib.hf_sweep_init(
        _ptr(A0), _ptr(Kv), A0.shape[0], _ptr(dks), _ptr(sm),
        int(sm.ndim == 3), _ptr(b), _ptr(x0), _ptr(x), _ptr(r), _ptr(parts),
        _ptr(lanes), B, B, nz, nr, nparts, _ptr(st), _ptr(tickets),
        _ptr(rtol_t), int(maxiter), int(rtol_wrt == "r0"), int(fixed),
        _counts_ptr(), _stream()), "sweep init")
    n = lib.hf_sweep_tiles2d(nz, nr)
    out = (x, r, parts[1, :, :n].sum(dim=1), parts[3, :, :n].sum(dim=1))
    return out if st is None else out + (st,)


def stencil_dot(A0, Kv, dks, sm, p, state=None):
    """The stencil-and-dot phase alone: (Ap, ⟨p, Ap⟩ per lane) with
    Ap = sm·A_b·(sm·p); the dots are float64. ``Kv=dks=None``: the Kv-free
    form. With a per-lane ``state``, the lanes it marks done are skipped
    (Ap and the dot 0) and the others get the alpha tail: the new state is
    returned last."""
    if _on_cpu(A0, Kv, dks, sm, p):
        return stencil_dot_reference(A0, Kv, dks, sm, p, state)
    lib, B, nz, nr, nparts, lanes = _phase_setup({"p": p}, A0, Kv, dks, sm)
    Ap = torch.zeros_like(p)
    parts = _parts(B, nparts, p.device)
    st, tickets = _tail_args(state, B, p.device)
    _check(lib.hf_sweep_stencil_dot(
        _ptr(A0), _ptr(Kv), A0.shape[0], _ptr(dks), _ptr(sm),
        int(sm.ndim == 3), _ptr(p), _ptr(Ap), _ptr(parts), _ptr(lanes), B, B,
        nz, nr, nparts, _ptr(st), _ptr(tickets), _counts_ptr(), _stream()),
        "sweep stencil_dot")
    pap = parts[0, :, :lib.hf_sweep_tiles2d(nz, nr)].sum(dim=1)
    return (Ap, pap) if st is None else (Ap, pap, st)


def update(x, r, p, Ap, alpha):
    """The update phase alone: (x + α·p, r − α·Ap, ⟨r', r'⟩ per lane) for
    α (B,) float64; the inputs are left as they are."""
    if _on_cpu(x, r, p, Ap, alpha):
        return update_reference(x, r, p, Ap, alpha)
    x_n, r_n, rr, _ = _update(x, r, p, Ap,
                              pack_state(x.shape[0], x.device, alpha=alpha),
                              tail=False, maxiter=0, fixed=False)
    return x_n, r_n, rr


def update_beta(x, r, p, Ap, state, *, maxiter: int, fixed: bool = False):
    """The update phase with the identity form's beta tail: (x + α·p,
    r' = r − α·Ap, ⟨r', r'⟩, new state) with α from each lane's state; a
    lane the state marks done is left as it is (its dot 0)."""
    if _on_cpu(x, r, p, Ap, state):
        return update_beta_reference(x, r, p, Ap, state, maxiter=maxiter,
                                     fixed=fixed)
    return _update(x, r, p, Ap, state, tail=True, maxiter=maxiter,
                   fixed=fixed)


def _update(x, r, p, Ap, state, *, tail, maxiter, fixed):
    lib, B, nz, nr, nparts, lanes = _phase_setup(
        {"x": x, "r": r, "p": p, "Ap": Ap})
    x_n, r_n = x.clone(), r.clone()
    parts = _parts(B, nparts, x.device)
    st, tickets = _tail_args(state, B, x.device)
    _check(lib.hf_sweep_update(
        _ptr(x_n), _ptr(r_n), _ptr(p), _ptr(Ap), _ptr(parts), _ptr(st),
        _ptr(tickets), int(tail), _ptr(lanes), B, B, nz, nr, nparts,
        int(maxiter), int(fixed), _counts_ptr(), _stream()), "sweep update")
    return x_n, r_n, parts[1, :, :lib.hf_sweep_tiles(nz, nr)].sum(dim=1), st


def pcr_r(A0, Kv, dks, sm, r, state=None, rr=None, bb=None, rtol=0.0, *,
          maxiter: int = 0, rtol_wrt: str = "b", fixed: bool = False):
    """The r-line PCR phase alone: (z, ⟨r, z⟩ per lane); the dots are
    float64. With a per-lane ``state`` and ⟨r, r⟩ ``rr``, ⟨b, b⟩ ``bb``
    (B,) float64, the start of an r-line solve (see
    :func:`pcr_r_reference`): the new state is returned last."""
    _check_rtol_wrt(rtol_wrt)
    if state is not None and (rr is None or bb is None):
        raise ValueError("the start's tail needs rr and bb with the state")
    if _on_cpu(A0, Kv, dks, sm, r, state, rr, bb):
        return pcr_r_reference(A0, Kv, dks, sm, r, state, rr, bb, rtol,
                               maxiter=maxiter, rtol_wrt=rtol_wrt,
                               fixed=fixed)
    lib, B, nz, nr, nparts, lanes = _phase_setup({"r": r}, A0, Kv, dks, sm)
    z = torch.zeros_like(r)
    parts = _parts(B, nparts, r.device)
    st, tickets = _tail_args(state, B, r.device)
    rtol_t = None
    if st is not None:
        parts[1, :, 0], parts[3, :, 0] = rr, bb
        rtol_t = _rtol_lanes(rtol, B, torch.float32, r.device).contiguous()
    _check(lib.hf_sweep_pcr_r(
        _ptr(A0), _ptr(Kv), _ptr(dks), _ptr(sm), int(sm.ndim == 3), _ptr(r),
        _ptr(z), _ptr(parts), _ptr(lanes), B, B, nz, nr, nparts, _ptr(st),
        _ptr(tickets), _ptr(rtol_t), int(maxiter), int(rtol_wrt == "r0"),
        int(fixed), _counts_ptr(), _stream()), "sweep pcr_r")
    rz = parts[2, :, :nz].sum(dim=1)
    return (z, rz) if st is None else (z, rz, st)


def pcr_r_update(A0, Kv, dks, sm, x, r, p, Ap, state, *, adi: bool = False,
                 maxiter: int = 0, fixed: bool = False, tail: bool = True):
    """The fused update and r-line PCR (``ks_pcr_r<true>``; with ``adi``
    the z-line phase after it, as an ADI iteration runs them):
    (x + α·p, r' = r − α·Ap, z = M⁻¹ r', ⟨r', r'⟩, ⟨r', z⟩, new state) with α
    from each lane's state and, with ``tail``, the beta tail in the kernel
    that writes ⟨r', z⟩ last; a lane the state marks done is left as it is
    (z and its dots 0). The inputs are left as they are."""
    if _on_cpu(A0, Kv, dks, sm, x, r, p, Ap, state):
        return pcr_r_update_state_reference(A0, Kv, dks, sm, x, r, p, Ap,
                                            state, adi=adi, maxiter=maxiter,
                                            fixed=fixed, tail=tail)
    lib, B, nz, nr, nparts, lanes = _phase_setup(
        {"x": x, "r": r, "p": p, "Ap": Ap}, A0, Kv, dks, sm)
    x_n, r_n, z = x.clone(), r.clone(), torch.zeros_like(r)
    parts = _parts(B, nparts, x.device)
    st, tickets = _tail_args(state, B, x.device)
    _check(lib.hf_sweep_pcr_r_update(
        _ptr(A0), _ptr(Kv), _ptr(dks), _ptr(sm), int(sm.ndim == 3),
        _ptr(x_n), _ptr(r_n), _ptr(p), _ptr(Ap), _ptr(z), _ptr(parts),
        _ptr(st), _ptr(tickets), int(tail), int(adi), _ptr(lanes), B, B, nz,
        nr, nparts, int(maxiter), int(fixed), _counts_ptr(), _stream()),
        "sweep pcr_r_update")
    n_rz = lib.hf_sweep_n_rz(nz, nr, 1, int(adi))
    return (x_n, r_n, z, parts[1, :, :nz].sum(dim=1),
            parts[2, :, :n_rz].sum(dim=1), st)


def pcr_z(A0, Kv, dks, sm, r, z_r):
    """The z-line phase of the ADI form alone: (z = (R r + Z r − r)·free,
    ⟨r, z⟩ per lane) given the r-line solve ``z_r`` = R r; the dots are
    float64; ``z_r`` is left as it is."""
    if _on_cpu(A0, Kv, dks, sm, r, z_r):
        return pcr_z_reference(A0, Kv, dks, sm, r, z_r)
    lib, B, nz, nr, nparts, lanes = _phase_setup({"r": r, "z_r": z_r}, A0,
                                                 Kv, dks, sm)
    z = z_r.clone()
    parts = _parts(B, nparts, r.device)
    _check(lib.hf_sweep_pcr_z(
        _ptr(A0), _ptr(Kv), _ptr(dks), _ptr(sm), int(sm.ndim == 3), _ptr(r),
        _ptr(z), _ptr(parts), _ptr(lanes), B, B, nz, nr, nparts,
        _counts_ptr(), _stream()), "sweep pcr_z")
    return z, parts[2, :, :lib.hf_sweep_z_tiles(nz, nr)].sum(dim=1)


def p_update(p, z, beta):
    """The search-direction phase alone: z + β·p per lane for β (B,)
    float64; p is left as it is."""
    if _on_cpu(p, z, beta):
        return p_update_reference(p, z, beta)
    lib, B, nz, nr, _, lanes = _phase_setup({"p": p, "z": z})
    p_n = p.clone()
    state = pack_state(B, p.device, beta=beta)
    _check(lib.hf_sweep_p_update(_ptr(p_n), _ptr(z), _ptr(state),
                                 _ptr(lanes), 0, B, nz, nr, _counts_ptr(),
                                 _stream()), "sweep p_update")
    return p_n


def merged_w(A0, Kv, dks, sm, u, r, state=None, *,
             preconditioned: bool = True, maxiter: int = 0):
    """The merged-dot pass alone: (w = sm·A_b·(sm·u), δ = ⟨w, u⟩, ⟨r, r⟩,
    γ = ⟨r, u⟩ per lane); the sums are float64. With a per-lane ``state``,
    the lanes it marks done are skipped (w and the sums 0) and the others
    get the merged recurrence's tail (a later step's scalars): the new
    state is returned last."""
    if _on_cpu(A0, Kv, dks, sm, u, r):
        return merged_w_reference(A0, Kv, dks, sm, u, r, state,
                                  preconditioned=preconditioned,
                                  maxiter=maxiter)
    lib, B, nz, nr, nparts, lanes = _phase_setup({"u": u, "r": r}, A0, Kv,
                                                 dks, sm)
    w = torch.zeros_like(u)
    parts = _parts(B, nparts, u.device)
    st, tickets = _tail_args(state, B, u.device)
    _check(lib.hf_sweep_merged_w(
        _ptr(A0), _ptr(Kv), A0.shape[0], _ptr(dks), _ptr(sm),
        int(sm.ndim == 3), _ptr(u), _ptr(r), _ptr(w), _ptr(parts),
        _ptr(lanes), B, B, nz, nr, nparts, _ptr(st), _ptr(tickets),
        int(preconditioned), int(maxiter), _counts_ptr(), _stream()),
        "sweep merged_w")
    delta, rr, gamma = parts[:3, :, :lib.hf_sweep_tiles2d(nz, nr)].sum(dim=-1)
    return (w, delta, rr, gamma) if st is None else (w, delta, rr, gamma, st)


def pq_update(p, q, u, w, beta):
    """The merged recurrence's direction phase alone: (u + β·p, w + β·q)
    per lane for β (B,) float64; p and q are left as they are."""
    if _on_cpu(p, q, u, w, beta):
        return pq_update_reference(p, q, u, w, beta)
    lib, B, nz, nr, _, lanes = _phase_setup({"p": p, "q": q, "u": u, "w": w})
    p_n, q_n = p.clone(), q.clone()
    state = pack_state(B, p.device, beta=beta)
    _check(lib.hf_sweep_pq_update(_ptr(p_n), _ptr(q_n), _ptr(u), _ptr(w),
                                  _ptr(state), _ptr(lanes), B, nz, nr,
                                  _counts_ptr(), _stream()),
           "sweep pq_update")
    return p_n, q_n


def compact(state):
    """The compaction phase alone: the lanes whose done flag is clear, in
    order (int32, one host read of their number)."""
    if _on_cpu(state):
        return compact_reference(state)
    lib = _library()
    B = _check_state(state, state.device)
    lanes = torch.empty(B, dtype=torch.int32, device=state.device)
    count = torch.empty((), dtype=torch.int32, device=state.device)
    _check(lib.hf_sweep_compact(_ptr(state), B, _ptr(lanes),
                                _ptr(count), _counts_ptr(), _stream()),
           "sweep compact")
    return lanes[:int(count.item())]


def finish(x, state, poison: bool = True):
    """The closing phase alone: (x with NaN over the lanes whose ‖r‖² is not
    finite when ``poison``, iters (B,) int32); x is left as it is."""
    if _on_cpu(x, state):
        return finish_reference(x, state, poison)
    lib, B, nz, nr, _, _ = _phase_setup({"x": x})
    if _check_state(state, x.device) != B:
        raise ValueError(f"state has {state.shape[0]} lanes, x {B}")
    x_n = x.clone()
    iters = torch.empty(B, dtype=torch.int32, device=x.device)
    _check(lib.hf_sweep_finish(_ptr(x_n), _ptr(iters),
                               _ptr(state), B, nz, nr,
                               int(poison), _counts_ptr(), _stream()),
           "sweep finish")
    return x_n, iters
