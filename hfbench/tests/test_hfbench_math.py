"""The frozen metric arithmetic on synthetic profiler timelines, the byte
and operation counts of both rooflines at the cells' shapes, the readers
on a synthetic run, and the traffic generator."""

import types

import numpy as np
import pytest

from hfbench import draws, harness
from hfbench.reference import chipmath

FLAGSHIP = (251, 1107)
SWEEP = (243, 1001)


def test_merged_busy_and_gaps():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert chipmath.merged_busy(spans) == 12 + 10 + 1
    timeline = [(s, e, "k") for s, e in spans]
    assert chipmath.idle_gaps(timeline) == [(12, 20), (30, 40)]
    assert chipmath.merged_busy([]) == 0.0


def test_idle_split_of_two_solves():
    """Two K1 solves with a host read inside the first; the step's kernels
    between them."""
    tl = [(0, 2, "k_step_prologue(float*)"),
          (3, 5, "k_init(float const*, int)"),
          (6, 8, "k_stencil_dot(float*)"),
          (8, 9, "Memcpy DtoH (Device -> Pinned)"),
          (12, 14, "k_update(float*)"),
          (14, 15, "k_finish(float*)"),
          (17, 18, "k_step_epilogue(float*)"),
          (20, 21, "k_init(float const*, int)"),
          (22, 23, "k_finish(float*)")]
    s = chipmath.idle_split(tl, "k_init", "k_finish")
    assert s["solves"] == 2
    assert s["idle_between_solves_us"] == 1 + 2 + 2
    assert s["idle_before_first_solve_us"] == 1
    assert s["idle_after_host_reads_us"] == 3
    assert s["idle_in_solves_us"] == 1 + 1
    assert s["host_reads"] == 1
    assert s["solve_span_us"] == 12 + 3


def test_k2_start_and_short_names():
    name = "void ks_apply<true, 1, 7>(float const*, float*)"
    assert chipmath.short_name(name) == "ks_apply<true, 1, 7>"
    assert chipmath.is_k2_start("ks_apply<true, 1, 7>")
    assert not chipmath.is_k2_start("ks_apply<true, 2, 7>")
    tl = [(0, 1, name), (2, 3, "ks_update(float*)"), (4, 5, "ks_finish(x)")]
    assert chipmath.idle_split(tl, "k2", "ks_finish")["solves"] == 1


@pytest.mark.parametrize("rline,zline,planes,ops", [
    (False, False, 14, 25), (True, False, 16, 37), (True, True, 18, 49)])
def test_k1_counts_at_the_flagship(rline, zline, planes, ops):
    plane = FLAGSHIP[0] * FLAGSHIP[1] * 4
    assert chipmath.k1_iter_bytes(plane, rline, zline) == planes * plane
    assert chipmath.k1_iter_ops(rline, zline) == ops
    b = chipmath.bound(1000 * planes * plane,
                       1000 * ops * FLAGSHIP[0] * FLAGSHIP[1])
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(
        1000 * planes * plane / 3.35e12 * 1e3)


def test_k2_counts_at_the_sweep():
    plane = SWEEP[0] * SWEEP[1] * 4
    its = np.array([10, 20, 0, 5])
    # shared A0 + Kv (14 planes) for the batch's 20 iterations; each lane's
    # x, r, p and scaling (7 planes) a lane-iteration
    assert chipmath.k2_solve_bytes(its, plane) == (20 * 14 + 35 * 7) * plane
    # the Kv-free projection: Mp and a shared scaling, 6 planes a lane
    assert chipmath.k2_solve_bytes(its, plane, kv=False,
                                   lane_scaling=False) \
        == (20 * 8 + 35 * 6) * plane
    assert chipmath.k2_iter_ops() == 39
    assert chipmath.k2_iter_ops(rline=True) == 39 + 21
    assert chipmath.k2_iter_ops(kv=False) == 25


def _run(cell, units, profile, shape):
    run = harness.new_run(cell, 1, 1.0, True)
    mesh = types.SimpleNamespace(shape=shape)
    run.problem = types.SimpleNamespace(mesh=mesh)
    run.units, run.profile, run.window_s = units, profile, 1.0
    return run


def _profile(kernels):
    timeline, t = [], 0.0
    for name, us in kernels:
        timeline.append((t, t + us, name))
        t += us + 1.0
    by = {}
    for s0, s1, name in timeline:
        by.setdefault(name, [0.0, 0])
        by[name][0] += s1 - s0
        by[name][1] += 1
    return dict(timeline=timeline, host=[], kernels=by,
                busy_us=chipmath.merged_busy((a, b) for a, b, _ in timeline))


def test_k1_roofline_reader():
    """The forms' iterations from the device's counts: 2 ADI solves and 1
    r-line solve launched 200 and 80 iterations, of which the run
    performed 220 (150 + 40 + 30); the 60 empty ones are shared by solve,
    40 to ADI and 20 to r-line. The step kernels and PyTorch's are not
    K1's, a renamed kernel is."""
    its = np.array([[150], [40], [30]])
    prof = _profile([("k_step_prologue(x)", 50.0), ("k_init(x)", 100.0),
                     ("k_renamed_solve(x)", 300.0),
                     ("void at::native::elementwise_kernel<x>()", 70.0)])
    unit = dict(iters=its, forms={"adi": [2, 200], "rline": [1, 80]})
    run = _run("flagship.transient", [unit], prof, FLAGSHIP)
    reader = harness.metric_reader("k1_roofline")
    plane, pts = FLAGSHIP[0] * FLAGSHIP[1] * 4, FLAGSHIP[0] * FLAGSHIP[1]
    nbytes = 160 * 18 * plane + 60 * 16 * plane
    ops = (160 * 49 + 60 * 37) * pts
    want = chipmath.bound(nbytes, ops)["bound_ms"] / 0.4 * 100
    assert reader.read(run) == pytest.approx(want)
    # a form without counts here, or no counted graph: nothing to read
    for forms in ({"mgz": [1, 80]}, {}):
        assert reader.read(_run("flagship.transient",
                                [dict(iters=its, forms=forms)], prof,
                                FLAGSHIP)) is None
    idle = harness.metric_reader("device_idle_pct.transient")
    assert idle.read(run) == pytest.approx(100 * (1 - 520e-6))
    assert harness.load_module("metrics", "k1.iters_per_step").read(run) \
        == pytest.approx(220 / 3)


def test_k2_readers_count_the_projection():
    its = np.array([[10, 20], [5, 0]])
    pits = np.array([[3, 3], [2, 2]])
    prof = _profile([("void ks_apply<true, 1, 7>(x)", 200.0),
                     ("ks_pcr_r(x)", 100.0), ("Memcpy DtoH", 10.0)])
    run = _run("sweep.record_b256",
               [dict(iters=its, proj_iters=pits)], prof, SWEEP)
    per = harness.load_module("metrics", "k2.us_per_lane_iter").read(run)
    assert per == pytest.approx(300.0 / (35 + 10))
    plane, pts = SWEEP[0] * SWEEP[1] * 4, SWEEP[0] * SWEEP[1]
    nbytes = ((20 * 14 + 30 * 7) + (5 * 14 + 5 * 7)
              + (3 * 8 + 6 * 6) + (2 * 8 + 4 * 6)) * plane
    ops = (35 * 60 + 10 * 25) * pts
    want = chipmath.bound(nbytes, ops)["bound_ms"] / 0.3 * 100
    assert harness.load_module("metrics", "k2_roofline").read(run) \
        == pytest.approx(want)


def test_readers_without_a_trace_return_nothing():
    run = _run("flagship.transient", [], None, FLAGSHIP)
    for name in ("k1_roofline", "stepper.idle_between_solves_ms",
                 "device_idle_pct.transient", "k2_roofline",
                 "k2.us_per_lane_iter"):
        assert harness.metric_reader(name).read(run) is None


def test_draws_are_one_set_in_the_seeds_order():
    box = {"kappa": [1.0, 100.0], "fwhm": [1e-6, 1e-4]}
    big = 2 ** 31 + 12345
    a = draws.draws(big, 0, 64, box, 40)
    b = draws.draws(big, 0, 64, box, 40)
    assert all(np.array_equal(a[k], b[k]) for k in box)
    other = draws.draws(big + 1, 0, 64, box, 40)
    assert not np.array_equal(a["kappa"], other["kappa"])
    points = draws.box_points(40, box)
    for d in (a, other):
        # each whole cycle is the set, in the seed's order
        for k in box:
            assert np.array_equal(np.sort(d[k][:40]), np.sort(points[k]))
            assert set(d[k][40:]) <= set(points[k])
    for k, (lo, hi) in box.items():
        assert points[k].min() >= lo and points[k].max() <= hi
        # the set covers each axis evenly
        u = (np.log(points[k]) - np.log(lo)) / (np.log(hi) - np.log(lo))
        assert np.histogram(u, bins=4, range=(0, 1))[0].min() >= 8
    assert np.array_equal(draws.draws(5, 10, 5, box, 8)["kappa"],
                          draws.draws(5, 0, 15, box, 8)["kappa"][10:])
    warm = draws.draws(5, -8, 8, box, 8)["kappa"]
    assert np.array_equal(np.sort(warm), np.sort(points["kappa"][:8]))
