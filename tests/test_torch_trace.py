"""The program's spans (``heatflow_tpu_torch.utils.span``) and the
benchmark's readers of them.

(a) a traced CPU run of each benchmarked path records the documented spans,
nested as documented, each a host event (``cpu_op``), never a user
annotation; (b) with no profiler running a span records nothing and costs
little; (c) K2's loop spans on a stub library; (d) each reader of the spans
on hand-built profiles, against values worked out by hand, and nothing
without the spans; the older device-trace readers give the same values
with the spans in the host's events; (e) on the card, the spans stay out
of the device timeline (marked ``cuda``; skipped here).
"""

import functools
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import heatflow_tpu_torch as T
from hfbench import harness
from heatflow_tpu_torch.geometry import coupler_watcher_points
from heatflow_tpu_torch.mesh.unstructured_gen import build_unstructured_mesh
from heatflow_tpu_torch.ops import cuda_sweep
from heatflow_tpu_torch.sim import sweepkernel
from heatflow_tpu_torch.sim.bc import HeatingCurve
from heatflow_tpu_torch.sim.problem import build_problem
from heatflow_tpu_torch.sim.stepper import make_simulate_fn
from heatflow_tpu_torch.sim.unstructured import (build_problem_unstructured,
                                                 make_simulate_fn_unstructured)
from heatflow_tpu_torch.utils import span
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

SPANS = ("transient", "transient.operands", "transient.load",
         "transient.capture", "transient.launch", "transient.wait",
         "transient.outputs", "transient.reorder", "transient.step",
         "k1.solve", "step.project",
         "sweep", "sweep.chunk", "sweep.project", "k2.solve", "k2.iterate",
         "k2.check")
STEPS = 4
KS = np.array([2.0, 7.5])
FS = np.array([4e-6, 9e-6])


@pytest.fixture(scope="module")
def problem():
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = STEPS
    df = synthetic_heating()
    return build_problem(T.build_structured_mesh(*T.build_layout(cfg)),
                         HeatingCurve(time=df["time"].to_numpy(),
                                      temp=df["temp"].to_numpy()),
                         cfg, watcher_points=coupler_watcher_points(cfg))


@functools.cache
def _triangulation():
    """The tiny stack on a graded triangulation with its grid overlay."""
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = STEPS
    df = synthetic_heating()
    mesh = build_unstructured_mesh(*T.build_layout(cfg), jitter=0.25,
                                   seed=7)
    return build_problem_unstructured(
        mesh, HeatingCurve(time=df["time"].to_numpy(),
                           temp=df["temp"].to_numpy()),
        cfg, watcher_points=coupler_watcher_points(cfg))


def _profiled(body, activities=(ProfilerActivity.CPU,)):
    with profile(activities=list(activities)) as prof:
        body()
    return list(prof.profiler.kineto_results.events())


def _parents(events) -> list[tuple[str, str | None]]:
    """(span, the innermost span around it) of each span event."""
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in events if e.name() in SPANS),
                   key=lambda s: (s[0], -s[1]))
    out, stack = [], []
    for s0, s1, name in spans:
        while stack and not (stack[-1][0] <= s0 and s1 <= stack[-1][1]):
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((s0, s1, name))
    return out


# each path: the call, and {span: (the span around it, how many)}
PATHS = {
    "eager_recording": (
        lambda p: make_simulate_fn(p, dtype=torch.float64, device="cpu",
                                   record_gradient=True)(),
        {"transient": (None, 1),
         "transient.operands": ("transient", 2),
         "transient.step": ("transient", STEPS),
         "k1.solve": ("transient.step", STEPS),
         "step.project": ("transient.step", STEPS)}),
    "eager_flagship_recipe": (
        lambda p: make_simulate_fn(
            p, dtype=torch.float32, device="cpu", solver="vmem",
            precondition="adaptive", f64_refine=1, rtol=1e-4,
            warm_start="extrapolate", record_gradient=False).forward_eager(),
        {"transient": (None, 1),
         "transient.operands": ("transient", 3),
         "transient.step": ("transient", STEPS),
         "k1.solve": ("transient.step", STEPS)}),
    # the overlay's eager loop (the CPU), the structured stepper's: the
    # reorders at the call's edges
    "unstructured_recording": (
        lambda p: make_simulate_fn_unstructured(
            _triangulation(), dtype=torch.float64, device="cpu",
            record_gradient=True)(),
        {"transient": (None, 1),
         "transient.operands": ("transient", 1),
         "transient.reorder": ("transient", 2),
         "transient.step": ("transient", STEPS),
         "k1.solve": ("transient.step", STEPS),
         "step.project": ("transient.step", STEPS)}),
    "unstructured_kernel_refined": (
        lambda p: make_simulate_fn_unstructured(
            _triangulation(), dtype=torch.float32, device="cpu",
            solver="vmem", precondition="rline", f64_refine=1, rtol=1e-4,
            warm_start="extrapolate", record_gradient=False)(),
        {"transient": (None, 1),
         "transient.operands": ("transient", 2),
         "transient.reorder": ("transient", 2),
         "transient.step": ("transient", STEPS),
         "k1.solve": ("transient.step", STEPS)}),
    "sweep_chunked": (
        lambda p: sweepkernel.run_sweep_time_chunked(
            p, KS, FS, step_chunk=2, solver="vmem", rtol=1e-4,
            device="cpu"),
        {"sweep": (None, 1), "sweep.chunk": ("sweep", 2)}),
    "sweep_recording": (
        lambda p: sweepkernel.make_sweep_fn_recording(
            p, dtype=torch.float32, solver="vmem", precondition="rline",
            device="cpu")(KS, FS),
        {"sweep": (None, 1), "sweep.chunk": ("sweep", 1),
         "sweep.project": ("sweep.chunk", STEPS)}),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_a_traced_run_records_its_spans_nested(problem, path):
    call, want = PATHS[path]
    call(problem)                     # the module made outside the trace
    got: dict = {}
    for name, parent in _parents(_profiled(lambda: call(problem))):
        got.setdefault(name, []).append(parent)
    assert sorted(got) == sorted(want)
    for name, (parent, count) in want.items():
        assert got[name] == [parent] * count, name


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_are_host_events_not_user_annotations(problem, path):
    call, want = PATHS[path]
    events = [e for e in _profiled(lambda: call(problem))
              if e.name() in SPANS]
    assert {e.name() for e in events} == set(want)
    for e in events:
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation()


def test_without_a_profiler_a_span_records_nothing():
    for _ in range(1000):
        with span("k2.check"):
            pass
    events = _profiled(lambda: torch.ones(2).sum())
    assert not [e for e in events if e.name() in SPANS]
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with span("k2.check"):
            pass
    # about 0.2 us here; the bound leaves room for a loaded host
    assert (time.perf_counter() - t0) / n < 20e-6


def test_k2_loop_spans_on_a_stub_library(monkeypatch):
    """``_Solve.iterate`` and ``_Solve.running`` (the card's loop) record
    ``k2.iterate`` and ``k2.check`` around their library calls."""
    calls = []
    lib = types.SimpleNamespace(
        hf_sweep_iterate=lambda *a: calls.append("iterate") or 0,
        hf_sweep_compact=lambda *a: calls.append("compact") or 0)
    solve = cuda_sweep._Solve.__new__(cuda_sweep._Solve)
    solve.lib, solve.args, solve.B, solve.stream = lib, (), 4, None
    solve.state = solve.lanes = None
    solve.count = torch.tensor(3, dtype=torch.int32)
    monkeypatch.setattr(cuda_sweep.cg_batched_tol, "iteration_launches", {})
    running = []
    events = _profiled(lambda: (solve.iterate(8, 4, "identity"),
                                running.append(solve.running())))
    assert calls == ["iterate", "compact"] and running == [3]
    assert [e.name() for e in events if e.name() in SPANS] == \
        ["k2.iterate", "k2.check"]
    assert cuda_sweep.cg_batched_tol.iteration_launches == \
        {"identity": [0, 8]}


# ----------------------------------------------------------------------
# (d) the readers on hand-built profiles (times in us)
# ----------------------------------------------------------------------

DTOH = "Memcpy DtoH (Device -> Pageable)"


def _transient(t):
    """One flagship transient from ``t``: its host spans and its device
    events (the operands' kernels and copies, the graph, the wait's copy,
    the outputs' copy)."""
    host = [(0, 100, "transient"), (1, 10, "transient.operands"),
            (12, 15, "transient.operands"), (15, 20, "transient.load"),
            (16, 17, "cudaMemcpyAsync"), (21, 22, "transient.launch"),
            (23, 80, "transient.wait"), (24, 79, "cudaMemcpyAsync"),
            (80, 85, "transient.outputs")]
    device = [(2, 4, "at::mul"), (6, 8, "at::add"), (13, 14, "k_pcr"),
              (16, 17, "Memcpy DtoD"), (18, 19, "Memcpy DtoD"),
              (22, 30, "k_step_prologue(double*)"),
              (31, 50, "k_row_update(float*)"),
              (52, 70, "k_step_epilogue(double*)"), (71, 72, DTOH),
              (81, 82, "Memcpy DtoD")]
    shift = lambda evs: [(s + t, e + t, n) for s, e, n in evs]
    return shift(host), shift(device)


def _sweep():
    host = [(0, 200, "sweep"), (1, 199, "sweep.chunk"), (5, 150, "k2.solve"),
            (10, 20, "k2.check"), (11, 19, "aten::item"),
            (21, 30, "k2.iterate"), (60, 70, "k2.check"),
            (71, 80, "k2.iterate"), (120, 130, "k2.check")]
    device = [(0, 9, "ks_apply<true, 1, 7>(float*)"), (12, 13, DTOH),
              (25, 55, "ks_update(float*)"), (58, 65, "ks_p_update(float*)"),
              (66, 67, DTOH), (75, 118, "ks_apply<true, 0, 7>(float*)"),
              (125, 126, DTOH), (140, 150, "ks_finish(float*)")]
    return host, device


def _run(host, device, units, **kw):
    from hfbench.reference import chipmath
    kernels: dict = {}
    for s0, s1, name in device:
        acc = kernels.setdefault(name, [0.0, 0])
        acc[0] += s1 - s0
        acc[1] += 1
    profile_ = dict(timeline=sorted(device), host=sorted(host),
                    kernels=kernels,
                    busy_us=chipmath.merged_busy((s, e) for s, e, _ in device))
    return types.SimpleNamespace(profile=profile_, units=units, **kw)


def _flagship_run(spans=True):
    host, device = [], []
    for t in (0, 100):
        h, d = _transient(t)
        host += h if spans else [e for e in h if e[2] not in SPANS]
        device += d
    return _run(host, device, [{}, {}])


def _sweep_run(spans=True):
    host, device = _sweep()
    if not spans:
        host = [e for e in host if e[2] not in SPANS]
    return _run(host, device, [dict(steps=40 * 4, configs=4)])


# by hand, a transient: operands and load merge to [1, 10] + [12, 20]: 17
# us; the idle gaps over them: (4, 6) 2, (8, 10) + (12, 13) 3, (14, 16) 2,
# (17, 18) 1, (19, 20) 1: 9 us, and the second transient's also the end
# of the gap since the first one's last copy, (101, 102): 19 us over two;
# the graph (22-70) idles (30, 31) and (50, 52): 3 us. The sweep: 3 reads over 40 steps; the gaps that begin
# in a read: (13, 25) 12, (65, 66) 1, (67, 75) 8, (126, 140) 14: 35 us
READERS = {
    "stepper.prepare_ms": (_flagship_run, 0.017),
    "stepper.idle_in_prepare_ms": (_flagship_run, 0.0095),
    "stepper.idle_in_graph_ms": (_flagship_run, 0.003),
    "sweep.reads_per_step": (_sweep_run, 3 / 40),
    "sweep.reads_per_step.record": (_sweep_run, 3 / 40),
    "sweep.idle_at_reads_ms": (_sweep_run, 0.035),
    "sweep.idle_at_reads_ms.record": (_sweep_run, 0.035),
}


@pytest.mark.parametrize("name", list(READERS))
def test_reader_on_a_hand_built_profile(name):
    make, want = READERS[name]
    got = harness.metric_reader(name).read(make())
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", list(READERS))
def test_reader_without_spans_or_device_reads_nothing(name):
    make, _ = READERS[name]
    reader = harness.metric_reader(name)
    assert reader.read(make(spans=False)) is None
    run = make()
    run.profile["timeline"] = []
    assert reader.read(run) is None
    run.profile = None
    assert reader.read(run) is None


def test_graph_idle_needs_the_wait_copy():
    run = _flagship_run()
    run.profile["timeline"] = [e for e in run.profile["timeline"]
                               if e[2] != DTOH]
    assert harness.metric_reader("stepper.idle_in_graph_ms").read(run) \
        is None


def _k1_run(spans):
    host, device = _flagship_run(spans).profile["host"], []
    for t in (0, 100):
        device += _transient(t)[1]
    device += [(200, 230, "k_init(float*)"), (231, 240, "k_finish(float*)")]
    run = _run(host, device, [
        dict(forms={"rline": [2, 80]}, iters=np.array([[30], [34]])),
        dict(forms={"adi_merged": [2, 40]}, iters=np.array([[20], [16]]))])
    run.problem = types.SimpleNamespace(
        mesh=types.SimpleNamespace(shape=(251, 1107)))
    run.window_s = 300e-6
    return run


def _k2_run(spans):
    run = _sweep_run(spans)
    run.units[0].update(iters=np.array([[30, 22, 8, 12]] * 40),
                        proj_iters=np.array([[5, 6, 7, 8]] * 40))
    run.problem = types.SimpleNamespace(
        mesh=types.SimpleNamespace(shape=(243, 1001)))
    run.params = dict(recipe=dict(precondition="rline"))
    run.window_s = 250e-6
    return run


@pytest.mark.parametrize("name,make", [
    ("k1_roofline", _k1_run), ("device_idle_pct.transient", _k1_run),
    ("stepper.idle_between_solves_ms", _k1_run),
    ("k2_roofline.record", _k2_run), ("k2.us_per_lane_iter.record", _k2_run),
    ("device_idle_pct.sweep_record", _k2_run)])
def test_device_readers_ignore_the_spans(name, make):
    reader = harness.metric_reader(name)
    without, with_spans = reader.read(make(False)), reader.read(make(True))
    assert without is not None and without > 0
    assert with_spans == without


# ----------------------------------------------------------------------
# (e) on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("path", ["graph", "sweep"])
def test_spans_stay_off_the_device_on_cuda(problem, path):
    """On the card each span is a host event and no device event carries a
    span's name: the graph path's transient (the recipe of
    ``flagship.transient``) and a K2 sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    if path == "graph":
        fn = make_simulate_fn(problem, dtype=torch.float32, device=dev,
                              solver="vmem", precondition="adaptive",
                              f64_refine=1, rtol=1e-4,
                              warm_start="extrapolate",
                              record_gradient=False)
        call = fn
        want = {"transient", "transient.operands", "transient.load",
                "transient.launch", "transient.wait", "transient.outputs"}
    else:
        def call():
            return sweepkernel.run_sweep_time_chunked(
                problem, KS, FS, step_chunk=2, solver="vmem", rtol=1e-4,
                device=dev)
        want = {"sweep", "sweep.chunk", "k2.solve", "k2.iterate",
                "k2.check"}
    # CUPTI started before any graph is captured, as the benchmark does
    _profiled(lambda: torch.ones(1, device=dev).add_(1),
              (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    call()
    torch.cuda.synchronize(dev)
    events = _profiled(lambda: (call(), torch.cuda.synchronize(dev)),
                       (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    cuda = torch.autograd.DeviceType.CUDA
    device_names = {e.name() for e in events if e.device_type() == cuda}
    assert device_names and not device_names & set(SPANS)
    host = [e for e in events if e.name() in SPANS]
    assert {e.name() for e in host} == want
    assert all(e.device_type() != cuda and not e.is_user_annotation()
               for e in host)
