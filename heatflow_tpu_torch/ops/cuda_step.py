"""The structured transient's step as device work: the kernels of
``csrc/step.cu`` with their plain PyTorch versions, and the CUDA graph that
runs a whole transient on the kernel path.

The JAX package runs the transient as one XLA program
(heatflow_tpu/sim/stepper.py ``_core``: ``jax.jit`` of a ``lax.scan``
whose body holds the step's elementwise work as XLA fusions and a
``lax.cond`` on the previous step's iteration count). It has no Pallas
kernel there; these kernels are the counterparts of those fusions. A step:

* ``step_prologue``: b_lift = (M_op·u_n + b_src − (A g0 + amp_n·A g1))·s,
  bt = b_lift·free and the warm-start seed y0 = seed/s·free, with the
  partial sums of ⟨bt, bt⟩ (the refinement's degenerate-rhs floor);
* per float64 refinement pass, ``refine_residual``: r64 = bt −
  free·s·A(s·y), y first taking the previous pass's correction, with
  ⟨r64, r64⟩ summed in a last-block tail that sets rnorm and rtol_eff as
  :func:`heatflow_tpu_torch.ops.cg.refine_inner_scale` does; then
  ``refine_scale``: the inner right-hand side r64/rnorm in float32 and the
  inner seed (zero, or the carried correction of
  :func:`heatflow_tpu_torch.ops.cg.refine_inner_seed`), written where the
  solve reads them;
* the inner solve: ``cg_tol``'s recorded solve (``csrc/cg_tol.cu``), the
  r-line or ADI form picked on the device under ``precondition='adaptive'``;
* ``step_epilogue``: u = y·s·free + g (y with the last pass's correction
  added), the watcher row, the step's iteration count and the adaptive
  flag for the next step.

Each kernel's plain version below is the step's arithmetic as the eager
step loop (``sim/stepper.GraphPath._run_eager``) runs it, on any operator
format. A workspace with ELL column ids (``cols``: a mesh with no lattice,
its nodes a 1 × N grid) holds (N, K) operators, which the kernels apply as
``ops/ell.py``'s gather and the solve as ``cg_tol``'s ELL form. The
kernels round each product and sum as the plain versions do (``__fmul_rn``
/ ``__dadd_rn`` ..., the stencil summed in ``apply_stencil``'s order, a
row's ELL slots in ``ell_apply``'s), so the planes are bitwise the eager
loop's; only the two inner products are summed in another (fixed) order.

A :class:`StepWorkspace` holds every plane a run reads and writes, so one
captured graph serves every call of a simulator: the call's operands are
copied in, the graph launched once (a conditional WHILE node over the
steps), the outputs copied out. The device counts each kernel's launches
and each solve form's solves in the step state; the host reads them once,
after the run. On a CPU workspace each kernel's wrapper runs its plain
version.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from heatflow_tpu_torch.ops import cuda_cg
from heatflow_tpu_torch.ops.cg import refine_inner_scale, refine_inner_seed
from heatflow_tpu_torch.ops.ell import operator_product
from heatflow_tpu_torch.utils import span

WARM_ORDER = {"previous": 0, "extrapolate": 1, "extrapolate2": 2}


# ----------------------------------------------------------------------
# Plain versions (the eager step loop runs them)
# ----------------------------------------------------------------------

def warm_seed(prev, pp, ppp, warm_start: str):
    """The warm-start seed: the previous field, or its linear or quadratic
    extrapolation in time."""
    if warm_start == "extrapolate2":
        return 3.0 * (prev - pp) + ppp
    return 2.0 * prev - pp if warm_start == "extrapolate" else prev


def step_prologue_reference(apply, M_op, u_prev, u_pp, u_ppp, b_src, Ag0,
                            Ag1, amp, s, free, warm_start: str):
    """(b_lift, y0): the step's lifted, scaled right-hand side and the
    scaled warm-start seed. ``apply(C, v)`` is the operator format's
    product; ``b_src`` is a plane or 0.0."""
    b = apply(M_op, u_prev) + b_src
    b_lift = (b - (Ag0 + amp * Ag1)) * s
    u_seed = warm_seed(u_prev, u_pp, u_ppp, warm_start)
    y0 = (u_seed / torch.where(s > 0, s, torch.ones_like(s))) * free
    return b_lift, y0


def _block_sums(v: torch.Tensor) -> torch.Tensor:
    """The step kernels' ``block_sum`` of each block of 256 values (zeros
    past the end): each warp's 32 lanes by the shuffle tree (lane l takes
    lane l + 16, then l + 8, ...), then the 8 warp sums in turn."""
    v = torch.nn.functional.pad(v, (0, (-v.numel()) % 256))
    x = v.reshape(-1, 8, 32)
    for o in (16, 8, 4, 2, 1):
        x = x[..., :o] + x[..., o:2 * o]
    warps = x[..., 0]
    out = torch.zeros(warps.shape[0], dtype=v.dtype, device=v.device)
    for w in range(8):
        out = out + warps[:, w]
    return out


def kernel_order_sum(v: torch.Tensor) -> torch.Tensor:
    """Σ v in the order the step kernels sum it: a partial a block of 256
    points (:func:`_block_sums`), then the last block's ``reduce_parts``
    (thread t adds partials t, t + 256, ... in turn; the 256 sums then by
    ``block_sum``). Bitwise the kernels' sums; ``torch.sum`` adds in
    another order."""
    parts = _block_sums(v.reshape(-1))
    rows = torch.nn.functional.pad(parts, (0, (-parts.numel()) % 256))
    acc = torch.zeros(256, dtype=v.dtype, device=v.device)
    for row in rows.reshape(-1, 256):
        acc = acc + row
    return _block_sums(acc)[0]


def _lane(v: torch.Tensor) -> torch.Tensor:
    """A scalar of each lane (its leading dims) against (..., Nz, Nr)
    planes."""
    return v[..., None, None]


def refine_residual_reference(apply, A, s, free, bt, y, floor2, rtol,
                              dtype: torch.dtype, dy=None, rnorm=None,
                              total=torch.sum):
    """One refinement pass's float64 residual: (y, r64, rnorm, rtol_eff),
    y first taking the previous pass's correction ``dy``·``rnorm`` when
    given. ``apply(C, v)`` is the operator format's product; ``total``
    sums ⟨r64, r64⟩, over the whole plane or one sum a lane
    (:func:`kernel_order_sum`: in the kernel's order), and ``floor2``,
    rnorm and rtol_eff have its shape."""
    if dy is not None:
        y = y + dy.to(y.dtype) * _lane(rnorm)
    r64 = bt - free * (s * apply(A, s * y))
    rn2 = total(r64 * r64)
    rnorm, rtol_eff = refine_inner_scale(rn2, floor2, rtol, dtype)
    return y, r64, rnorm, rtol_eff


def refine_scale_reference(r64, rnorm, rtol_eff, dtype: torch.dtype,
                           dy=None):
    """(r32, seed): the inner solve's unit-norm right-hand side and its
    seed, zero or the carried correction ``dy`` (zeroed on a degenerate
    pass)."""
    r32 = (r64 / _lane(rnorm)).to(dtype)
    seed = (refine_inner_seed(dy, rtol_eff).contiguous() if dy is not None
            else torch.zeros(r64.shape, dtype=dtype, device=r64.device))
    return r32, seed


def step_epilogue_reference(x, s, free, g0, g1, amp, dy=None, rnorm=None):
    """The new field u = x·s·free + (g0 + amp·g1), x first taking the last
    pass's correction ``dy``·``rnorm`` when given."""
    if dy is not None:
        x = x + dy.to(x.dtype) * _lane(rnorm)
    return x * s * free + (g0 + amp * g1)


# ----------------------------------------------------------------------
# The workspace
# ----------------------------------------------------------------------

# the step state (14 float64 words, ``StepState`` of csrc/step.cu): int32
# words 0 (the step n), 1 (the last step's iteration count), 2-3 (the tails'
# block tickets), 14 (the form of the current solve: 1 ADI); float64 words 2
# (floor2), 3-4 (the passes' rnorm); int64 words 5-6 (solves run on the
# r-line form, or the one form, and on the ADI form), 8-11 (the launches of
# the prologue, the residual, the scale and the epilogue), 12-13 (the two
# forms' solve loop bodies run)
_N, _IT_PREV, _ADI = 0, 1, 14
_FLOOR2, _RNORM, _SOLVES, _LAUNCHES, _RUNS = 2, 3, 5, 8, 12
_STATE_WORDS = 14


class StepWorkspace:
    """Every plane a transient on the kernel path reads and writes, at one
    shape, dtype and set of options: the operands (copied in by
    :meth:`load`), the ring of the last three fields, the refinement's
    planes, the inner solve's buffers (its right-hand side, seed and one
    output plane a pass, which the next step's carried seed reads), the
    outputs and the step state. ``solve`` holds the solve's form: 'pcr',
    'pcr_z', 'cheb', 'mgz', 'mgz_sweeps', 'merged', 'maxiter',
    'rtol_wrt'. The line operands are ``cuda_cg.rline_pack``'s and
    ``cuda_cg.zline_pack``'s three factor planes each. ``cols`` (int32
    (nz·nr, npts)): the operators are ELL gathers, (nz·nr, npts) values,
    in place of npts stencil planes."""

    def __init__(self, *, device, nz: int, nr: int, npts: int, cdt,
                 num_steps: int, f64_refine: int, carry: bool,
                 warm_start: str, adaptive: bool, thresh, rtol: float,
                 n_watch: int, record_fields: bool, has_src: bool,
                 solve: dict, cols: torch.Tensor | None = None):
        f = dict(dtype=cdt, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.device, self.nz, self.nr, self.npts = device, nz, nr, npts
        self.cols = cols
        # the operator format's product, which the plain versions take
        self.apply = operator_product(cols)
        op = (npts, nz, nr) if cols is None else (nz * nr, npts)
        self.cdt, self.num_steps = cdt, num_steps
        self.refine, self.passes = f64_refine > 0, max(1, f64_refine)
        self.carry, self.warm_start = carry, warm_start
        self.adaptive, self.thresh, self.rtol = adaptive, thresh, rtol
        self.solve = solve
        self.Mop = torch.empty(op, **f)
        self.s, self.free = torch.empty((nz, nr), **f), torch.empty((nz, nr),
                                                                     **f)
        self.g0, self.g1 = torch.empty((nz, nr), **f), torch.empty((nz, nr),
                                                                   **f)
        self.Ag0 = torch.empty((nz, nr), **f)
        self.Ag1 = torch.empty((nz, nr), **f)
        self.src = torch.empty((nz, nr), **f) if has_src else None
        self.amps = torch.empty(num_steps, **f)
        self.ring = torch.empty((3, nz, nr), **f)
        self.fields = torch.empty((num_steps, nz, nr), **f) \
            if record_fields else None
        self.watch = torch.empty((num_steps, n_watch), **f) if n_watch \
            else None
        self.watch_flat = None
        self.cg_iters = torch.empty(num_steps, dtype=torch.int32,
                                    device=device)
        self.state = torch.zeros(_STATE_WORDS, dtype=torch.float64,
                                 device=device)
        # the inner solve: operator, scaling, the r-line and the z-line
        # factors (float32)
        self.As = torch.empty(op, **f32)
        self.sm = torch.empty((nz, nr), **f32)
        self.pcr = torch.empty((3, nz, nr), **f32) if solve["pcr"] else None
        self.pcr_z = torch.empty((3, nz, nr), **f32) if solve["pcr_z"] \
            else None
        self.lmax = torch.empty(1, **f32)
        self.b32 = torch.empty((nz, nr), **f32)
        self.x0 = torch.empty((nz, nr), **f32)
        self.dx = torch.zeros((self.passes, nz, nr), **f32)
        self.rtol32 = torch.empty((), **f32)
        self.iters = torch.zeros(self.passes, dtype=torch.int32,
                                 device=device)
        if self.refine:
            self.A = torch.empty(op, **f)
            self.bt = torch.empty((nz, nr), **f)
            self.y = torch.empty((self.passes, nz, nr), **f)
            self.r64 = torch.empty((nz, nr), **f)
        else:
            # unrefined: the prologue writes the solve's rhs and seed
            self.A, self.bt, self.y, self.r64 = None, self.b32, \
                self.x0[None], None
        nparts = (nz * nr + 255) // 256
        self.part_bt = torch.empty(nparts, dtype=torch.float64, device=device)
        self.part_r = torch.empty(nparts, dtype=torch.float64, device=device)
        self.graph = None

    @property
    def on_cpu(self) -> bool:
        return self.device.type == "cpu"

    def load(self, *, Mop, s, free, g0, g1, Ag0, Ag1, src, amps, A, As, sm,
             pcr, pcr_z, u0, watch_flat) -> None:
        """Copy a call's operands in (the graph reads these buffers) and
        reset the state: the ring holds u0 three times, the carried
        corrections are zero."""
        with span("transient.load"):
            for dst, v in ((self.Mop, Mop), (self.s, s), (self.free, free),
                           (self.g0, g0), (self.g1, g1), (self.Ag0, Ag0),
                           (self.Ag1, Ag1), (self.src, src),
                           (self.amps, amps), (self.A, A), (self.As, As),
                           (self.sm, sm), (self.pcr, pcr),
                           (self.pcr_z, pcr_z)):
                if dst is not None:
                    dst.copy_(v)
            self.ring.copy_(u0.expand(3, *u0.shape))
            self.dx.zero_()
            self.state.zero_()
            self.watch_flat = watch_flat
            if self.solve["cheb"] > 0:
                self.lmax.copy_(cuda_cg.gershgorin_lmax(self.As, self.sm)
                                .reshape(1))
            if not self.refine:
                self.rtol32.fill_(float(self.rtol))

    # the state's fields, read and written by the plain versions
    def _ints(self):
        return self.state.view(torch.int32)

    def step_index(self) -> int:
        return int(self._ints()[_N])


def _form_of(ws: StepWorkspace) -> int:
    """The form of the next solve (1: ADI), as the kernel before it sets
    it: under 'adaptive', ADI after a step deeper than the threshold (the
    first step counts as ``maxiter``); counted into the state's solves."""
    ints = ws._ints()
    n = int(ints[_N])
    it_prev = ws.solve["maxiter"] if n == 0 else int(ints[_IT_PREV])
    adi = int(ws.adaptive and it_prev > ws.thresh)
    ints[_ADI] = adi
    ws.state.view(torch.int64)[_SOLVES + adi] += 1
    return adi


# ----------------------------------------------------------------------
# Kernel wrappers (each one launch; the plain version on the CPU)
# ----------------------------------------------------------------------

def _library():
    lib = cuda_cg._library()
    if lib.hf_step_state_bytes() != 8 * _STATE_WORDS \
            or lib.hf_step_args_bytes() != ctypes.sizeof(_StepArgs):
        raise RuntimeError("csrc/step.cu and ops/cuda_step.py disagree on "
                           "the step's argument or state layout")
    return lib


class _StepArgs(ctypes.Structure):
    """``StepArgs`` of csrc/step.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "Mop", "A", "s", "free", "g0", "g1", "Ag0", "Ag1", "src", "amps",
        "ring", "bt", "y0", "y1", "r64", "fields", "watch", "watch_flat",
        "cols", "b32", "x0", "dx0", "dx1", "rtol32", "iters", "cg_iters",
        "part_bt", "part_r", "state")] + [
        ("rtol", ctypes.c_double)] + [
        (name, ctypes.c_ulonglong) for name in (
            "h_rline0", "h_rline1", "h_adi0", "h_adi1", "h_loop")] + [
        (name, ctypes.c_int) for name in (
            "npts", "nz", "nr", "f64", "order", "passes", "carry", "n_watch",
            "num_steps", "adaptive", "thresh", "maxiter", "set_if",
            "set_loop")]


_ptr, _check = cuda_cg._ptr, cuda_cg._check


def _args(ws: StepWorkspace) -> _StepArgs:
    y = list(ws.y) + [None] * (2 - ws.passes) if ws.refine else [ws.x0,
                                                                 None]
    dx = list(ws.dx) + [None] * (2 - ws.passes)
    a = _StepArgs()
    for name, t in (("Mop", ws.Mop), ("A", ws.A), ("s", ws.s),
                    ("free", ws.free), ("g0", ws.g0), ("g1", ws.g1),
                    ("Ag0", ws.Ag0), ("Ag1", ws.Ag1), ("src", ws.src),
                    ("amps", ws.amps), ("ring", ws.ring), ("bt", ws.bt),
                    ("y0", y[0]), ("y1", y[1]), ("r64", ws.r64),
                    ("fields", ws.fields), ("watch", ws.watch),
                    ("watch_flat", ws.watch_flat), ("cols", ws.cols),
                    ("b32", ws.b32),
                    ("x0", ws.x0), ("dx0", dx[0]), ("dx1", dx[1]),
                    ("rtol32", ws.rtol32), ("iters", ws.iters),
                    ("cg_iters", ws.cg_iters), ("part_bt", ws.part_bt),
                    ("part_r", ws.part_r), ("state", ws.state)):
        if name == "part_bt" and not ws.refine:
            t = None                   # the floor is the refinement's
        setattr(a, name, _ptr(t))
    a.rtol = float(ws.rtol)
    a.npts, a.nz, a.nr = ws.npts, ws.nz, ws.nr
    a.f64 = int(ws.cdt == torch.float64)
    a.order = WARM_ORDER[ws.warm_start]
    a.passes = ws.passes if ws.refine else 0
    a.carry = int(ws.carry)
    a.n_watch = 0 if ws.watch is None else ws.watch.shape[1]
    a.num_steps = ws.num_steps
    a.adaptive = int(ws.adaptive)
    a.thresh = int(ws.thresh) if ws.adaptive else 0
    a.maxiter = int(ws.solve["maxiter"])
    return a


def step_prologue(ws: StepWorkspace) -> None:
    """The step's right-hand side and seed into the workspace (bt and the
    seed plane; unrefined, the solve's b32 and x0), for the step the state
    holds."""
    if ws.on_cpu:
        n = ws.step_index()
        prev, pp, ppp = (ws.ring[(n + k) % 3] for k in (2, 1, 0))
        b_lift, y0 = step_prologue_reference(
            ws.apply, ws.Mop, prev, pp, ppp,
            0.0 if ws.src is None else ws.src,
            ws.Ag0, ws.Ag1, ws.amps[n], ws.s, ws.free, ws.warm_start)
        bt = b_lift * ws.free
        ws.bt.copy_(bt)
        ws.y[0].copy_(y0)
        if ws.refine:
            ws.state[_FLOOR2] = 1e-30 * torch.sum(bt * bt)
        else:
            _form_of(ws)
        return
    _check(_library().hf_step_prologue(ctypes.byref(_args(ws)),
                                       cuda_cg._stream()), "step_prologue")
    step_prologue.launches += 1


def refine_residual(ws: StepWorkspace, p: int) -> None:
    """Refinement pass ``p``'s residual r64, its rnorm and the inner
    solve's rtol_eff (pass 1 first adds pass 0's correction to y)."""
    if ws.on_cpu:
        dy = ws.dx[p - 1] if p else None
        rn = ws.state[_RNORM + p - 1] if p else None
        y, r64, rnorm, rtol_eff = refine_residual_reference(
            ws.apply, ws.A, ws.s, ws.free, ws.bt, ws.y[max(p - 1, 0)],
            ws.state[_FLOOR2], ws.rtol, torch.float32, dy, rn)
        if p:
            ws.y[p].copy_(y)
        ws.r64.copy_(r64)
        ws.state[_RNORM + p] = rnorm
        ws.rtol32.copy_(rtol_eff)
        return
    _check(_library().hf_refine_residual(ctypes.byref(_args(ws)), p,
                                         cuda_cg._stream()),
           "refine_residual")
    refine_residual.launches += 1


def refine_scale(ws: StepWorkspace, p: int) -> None:
    """Pass ``p``'s inner right-hand side (b32) and seed (x0)."""
    if ws.on_cpu:
        r32, seed = refine_scale_reference(
            ws.r64, ws.state[_RNORM + p], ws.rtol32, torch.float32,
            ws.dx[p] if ws.carry else None)
        ws.b32.copy_(r32)
        ws.x0.copy_(seed)
        _form_of(ws)
        return
    _check(_library().hf_refine_scale(ctypes.byref(_args(ws)), p,
                                      cuda_cg._stream()), "refine_scale")
    refine_scale.launches += 1


def step_epilogue(ws: StepWorkspace) -> None:
    """The new field into the ring (and the recorded fields), the watcher
    row and the step's iteration count; advances the step."""
    if ws.on_cpu:
        ints = ws._ints()
        n = int(ints[_N])
        last = ws.passes - 1
        x = ws.y[last] if ws.refine else ws.dx[0]
        u = step_epilogue_reference(
            x, ws.s, ws.free, ws.g0, ws.g1, ws.amps[n],
            ws.dx[last] if ws.refine else None,
            ws.state[_RNORM + last] if ws.refine else None)
        ws.ring[n % 3].copy_(u)
        if ws.fields is not None:
            ws.fields[n].copy_(u)
        if ws.watch is not None:
            ws.watch[n].copy_(u.reshape(-1)[ws.watch_flat])
        it = ws.iters[0] if not ws.refine else \
            torch.zeros((), dtype=torch.int32) + ws.iters[0]
        for p in range(1, ws.passes):
            it = it + ws.iters[p]
        ws.cg_iters[n] = it
        ints[_IT_PREV] = it
        ints[_N] = n + 1
        return
    _check(_library().hf_step_epilogue(ctypes.byref(_args(ws)),
                                       cuda_cg._stream()), "step_epilogue")
    step_epilogue.launches += 1


_KERNELS = (step_prologue, refine_residual, refine_scale, step_epilogue)
for _fn in _KERNELS:
    _fn.launches = 0


def reset_counters() -> None:
    for fn in _KERNELS:
        fn.launches = 0


# ----------------------------------------------------------------------
# The transient
# ----------------------------------------------------------------------

def _forms(ws: StepWorkspace) -> list[bool]:
    """The solve forms of the graph, as 'has the z-line factors':
    [r-line, ADI] under 'adaptive', else the one form."""
    return [False, True] if ws.adaptive else [ws.pcr_z is not None]


def _desc(lib, ws: StepWorkspace, adi: bool, p: int, k1) -> ctypes.Array:
    """``cg_tol``'s solve record for pass ``p`` of the form: the
    workspace's operands and the shared solve buffers ``k1``."""
    sv = ws.solve
    mgz = sv["mgz"]
    nz, nr = ws.nz, ws.nr
    pcr_z = ws.pcr_z if adi else None
    r, z, Ap, pp, _ = k1["vecs"].unbind(0)   # p: the last two planes
    if ws.pcr is None and sv["cheb"] == 0:
        z = r                         # identity form: z aliases r
    ac9 = mgz.get("Ac9") if mgz is not None and sv["mgz_sweeps"] > 1 \
        else None
    buf = ctypes.create_string_buffer(lib.hf_solve_desc_bytes())
    _check(lib.hf_solve_desc(
        _ptr(ws.As), ws.npts, _ptr(ws.sm), _ptr(ws.b32), _ptr(ws.x0),
        _ptr(ws.rtol32), _ptr(ws.pcr), _ptr(pcr_z), _ptr(ws.dx[p]), _ptr(r),
        _ptr(z), _ptr(pp), _ptr(Ap),
        _ptr(k1["parts"]), k1["parts"].shape[1], _ptr(k1["state"]), nz, nr,
        int(sv["maxiter"]), int(sv["rtol_wrt"] == "r0"), None,
        _ptr(ws.lmax), int(sv["cheb"]), int(sv["merged"]), _ptr(ac9),
        _ptr(None if mgz is None else mgz["pcrc"]),
        _ptr(None if mgz is None else mgz["aux"]), int(sv["mgz_sweeps"]),
        0.8, 0.8, _ptr(k1["extra"]), None, 0, _ptr(ws.cols), buf),
        "solve_desc")
    return buf


class _StepGraph:
    """A captured transient: the executable graph, for each solve form the
    K1 launches of one solve's start and finish and of one loop body
    (``cuda_cg._Recorded``), and the K1 buffers the graph reads and
    writes."""

    def __init__(self, lib, exec_ptr, bodies, k1):
        self.lib, self.exec_ptr, self.bodies, self.k1 = lib, exec_ptr, \
            bodies, k1

    def __del__(self):
        self.lib.hf_graph_destroy(self.exec_ptr)


def _capture(ws: StepWorkspace) -> _StepGraph:
    with span("transient.capture"):
        lib = _library()
        dev, nz, nr, sv = ws.device, ws.nz, ws.nr, ws.solve
        f32 = dict(dtype=torch.float32, device=dev)
        n_extra = lib.hf_cg_extra_planes(sv["cheb"], int(sv["merged"]),
                                         int(sv["mgz"] is not None))
        k1 = dict(vecs=torch.empty((5, nz, nr), **f32),
                  parts=torch.empty((4, lib.hf_cg_nparts(nz, nr)),
                                    dtype=torch.float64, device=dev),
                  state=torch.empty(8, dtype=torch.float64, device=dev),
                  extra=torch.empty((n_extra, nz, nr), **f32) if n_extra
                  else None)
        forms = _forms(ws)
        descs = [_desc(lib, ws, adi, p, k1) for adi in forms
                 for p in range(ws.passes)]
        bodies = []
        for adi in forms:
            form = (ws.pcr, ws.pcr_z if adi else None, sv["cheb"],
                    sv["merged"], sv["mgz"] is not None)
            ell = ws.cols is not None
            bodies.append(cuda_cg._Recorded(
                cuda_cg._form_name(*form, ell=ell),
                cuda_cg._form_counters(*form, ell=ell),
                np.zeros(len(cuda_cg.PHASES), dtype=np.int64),
                np.zeros(len(cuda_cg.PHASES), dtype=np.int64)))
        P = ctypes.c_void_p
        handle = P()
        args = _args(ws)
        t0 = time.perf_counter()
        _check(lib.hf_step_graph(
            ctypes.byref(args),
            (P * len(descs))(*map(ctypes.addressof, descs)), len(forms),
            cuda_cg.CHECK_EVERY,
            (P * len(bodies))(*[b.counts.ctypes.data for b in bodies]),
            (P * len(bodies))(*[b.counts_body.ctypes.data for b in bodies]),
            ctypes.byref(handle)), "step graph capture")
        capture_s = time.perf_counter() - t0
        for b in bodies:
            b.capture_s = capture_s
            cuda_cg._recorded[b.form_name] = b
        return _StepGraph(lib, handle.value, bodies, k1)


def run(ws: StepWorkspace) -> None:
    """The whole transient on the loaded workspace of a CUDA device: one
    launch of the captured graph (:func:`launch`), then the launch counts
    read once (:func:`count_launches`). The host reads nothing while the
    steps run."""
    count_launches(ws, launch(ws))


def run_stepwise(ws: StepWorkspace) -> None:
    """The plain version of :func:`run` that the tests put in its place:
    the graph's transient a launch at a time, the host looping over the
    steps and passes: each step wrapper (its plain version on a CPU
    workspace) and each pass's ``cg_tol`` solve (the plain version, or the
    kernel launched eagerly), the form of each solve read back from the
    state where the wrapper before it set it."""
    sv, ints = ws.solve, ws._ints()
    for _ in range(ws.num_steps):
        step_prologue(ws)
        for p in range(ws.passes):
            if ws.refine:
                refine_residual(ws, p)
                refine_scale(ws, p)
            adi = bool(ints[_ADI]) if ws.adaptive else ws.pcr_z is not None
            x, its = cuda_cg.cg_tol(
                ws.As, ws.sm, ws.b32, ws.x0, ws.rtol32,
                maxiter=int(sv["maxiter"]), rtol_wrt=sv["rtol_wrt"],
                pcr=ws.pcr, pcr_z=ws.pcr_z if adi else None,
                cheb_degree=sv["cheb"], merged=sv["merged"], mgz=sv["mgz"],
                mgz_sweeps=sv["mgz_sweeps"], cols=ws.cols)
            ws.dx[p].copy_(x)
            ws.iters[p].copy_(its)
        step_epilogue(ws)


def launch(ws: StepWorkspace) -> _StepGraph:
    """Queue the whole transient on the card (the graph captured at the
    workspace's first run: it reads and writes only the workspace's
    buffers); the host reads nothing."""
    if ws.on_cpu:
        raise ValueError("the transient's graph runs on a CUDA device")
    if ws.graph is None:
        ws.graph = _capture(ws)
    g = ws.graph
    with span("transient.launch"):
        _check(g.lib.hf_graph_launch(g.exec_ptr, cuda_cg._stream()),
               "step graph launch")
    return g


def count_launches(ws: StepWorkspace, g: _StepGraph) -> None:
    """Add a launched transient's launches, as the device counted them in
    the step state (one read, which waits for the run), to the step
    kernels' counters, and its solves by form (with their loop bodies'
    runs) to ``cg_tol``'s."""
    with span("transient.wait"):
        words = ws.state.view(torch.int64).tolist()
    for fn, n in zip(_KERNELS, words[_LAUNCHES:_LAUNCHES + 4]):
        fn.launches += n
    for f, b in enumerate(g.bodies):
        cuda_cg._count_solves(b, words[_SOLVES + f], words[_RUNS + f])
