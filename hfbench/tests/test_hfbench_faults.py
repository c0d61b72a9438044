"""A whole run of each cell on the CPU at a small size, with the program's
timed path broken underneath, must come out not correct; the same run
unbroken comes out correct. The faults a cell can have: a step that
returns its state unchanged; half of the batch left out (the sweeps); an
answer altered where it is produced; in the sweep whose steps are held to
the recipe's stopping rule, the state carried in bfloat16. No cell runs
across chips, so no exchange between chips can be left out."""

import time

import numpy as np
import pytest
import torch

from hfbench import harness

CELLS = ("flagship.transient", "sweep.b1024", "sweep.record_b256")
SWEEPS = ("sweep.b1024", "sweep.record_b256")


def cpu_run(cell, small):
    return harness.run_cell(cell, 2 ** 31 + 99, 0.2, False, "cpu",
                            time.perf_counter(), overrides=small[cell])


def limit(cell):
    spec = harness.load_json(harness.ROOT + "/BENCHMARK.json")
    return harness.find_cell(spec, cell)[0]["params"]["limits"]["watch_gap_K"]


def unchanged_step(monkeypatch, ic):
    """Every step ends on the state it started from: the initial field."""
    from heatflow_tpu_torch.sim import stepper
    epilogue = stepper.step_epilogue_reference
    monkeypatch.setattr(stepper, "step_epilogue_reference",
                        lambda *a, **k: torch.full_like(epilogue(*a, **k),
                                                        ic))


def sweep_scan(monkeypatch, change):
    from heatflow_tpu_torch.sim import sweepkernel
    scan = sweepkernel.vmem_sweep_scan
    monkeypatch.setattr(sweepkernel, "vmem_sweep_scan",
                        lambda *a, **k: change(scan, *a, **k))


def unchanged_lanes(scan, ops, ks, fs, u0, u_pp, step0, **k):
    out, _, _ = scan(ops, ks, fs, u0, u_pp, step0, **k)
    flat = lambda t: torch.full_like(t, float(k["ic"]))
    out = ({n: flat(t) for n, t in out.items()} if isinstance(out, dict)
           else flat(out))
    return out, u0, u_pp


def half_batch(scan, ops, ks, fs, u0, u_pp, step0, **k):
    h = len(ks) // 2
    out, u1, u2 = scan(ops, ks[:h], fs[:h], u0[:h], u_pp[:h], step0, **k)
    pad = lambda t: torch.cat([t, torch.zeros((len(ks) - h,) + t.shape[1:],
                                              dtype=t.dtype)])
    out = ({n: pad(t) for n, t in out.items()} if isinstance(out, dict)
           else pad(out))
    return out, pad(u1), pad(u2)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, small):
    line = cpu_run(cell, small)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_not_correct(cell, small, monkeypatch):
    if cell in SWEEPS:
        sweep_scan(monkeypatch, unchanged_lanes)
    else:
        spec = harness.load_json(harness.ROOT + "/BENCHMARK.json")
        config = harness.find_cell(spec, cell)[1]
        unchanged_step(monkeypatch, config["config"]["heating"]["ic_temp"])
    line = cpu_run(cell, small)
    assert line["correct"] is False and line["failed"] > 0


@pytest.mark.parametrize("cell", SWEEPS)
def test_half_the_batch_left_out_is_not_correct(cell, small, monkeypatch):
    sweep_scan(monkeypatch, half_batch)
    line = cpu_run(cell, small)
    assert line["correct"] is False and line["failed"] >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(cell, small, monkeypatch):
    delta = 10.0 * limit(cell)
    if cell in SWEEPS:
        def altered(scan, *a, **k):
            out, u1, u2 = scan(*a, **k)
            if isinstance(out, dict):
                out = dict(out, watch=out["watch"] + delta)
            else:
                out = out + delta
            return out, u1, u2
        sweep_scan(monkeypatch, altered)
    else:
        from heatflow_tpu_torch.sim import stepper
        epilogue = stepper.step_epilogue_reference
        monkeypatch.setattr(stepper, "step_epilogue_reference",
                            lambda *a, **k: epilogue(*a, **k) + delta)
    line = cpu_run(cell, small)
    gap = next(c for c in line["checks"] if c["name"] == "watch_gap_K")
    assert line["correct"] is False and gap["value"] > gap["limit"]
    assert np.isfinite(gap["value"])


def test_state_kept_in_bfloat16_is_not_correct(small, monkeypatch):
    """The B = 1024 sweep with each step's new fields rounded to bfloat16
    before the next step reads them (the traces read before the rounding):
    its chunk-end steps miss the stopping rule."""
    from heatflow_tpu_torch.sim import sweepkernel
    scan = sweepkernel._sweep_scan

    def bf16_state(*a, **k):
        k["project"] = lambda U: U.copy_(U.to(torch.bfloat16).to(U.dtype))
        return scan(*a, **k)
    monkeypatch.setattr(sweepkernel, "_sweep_scan", bf16_state)
    line = cpu_run("sweep.b1024", small)
    resid = next(c for c in line["checks"] if c["name"] == "step_resid")
    assert line["correct"] is False and resid["value"] > resid["limit"]
    gap = next(c for c in line["checks"] if c["name"] == "watch_gap_K")
    assert gap["value"] <= gap["limit"]
