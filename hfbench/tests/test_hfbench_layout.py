"""The harness finds cells, configurations, traffic families and metrics by
name; a new file is picked up with no edit; the result line's keys; no JAX
in a run's process; no result without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from hfbench import harness

ROOT = harness.ROOT
SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def cpu_run(cell, overrides, trace=False, root=ROOT, seed=2 ** 31 + 7):
    return harness.run_cell(cell, seed, 0.5, trace, "cpu",
                            time.perf_counter(), root=root,
                            overrides=overrides)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    workload, config = harness.find_cell(SPEC, cell)
    family = harness.load_module("traffic", workload["traffic"])
    assert callable(family.setup) and callable(family.unit)
    assert config["reduced"] == [] and len(config["source"]) <= 200
    assert set(workload["params"]["limits"]) >= {"watch_gap_K",
                                                 "unanswered"}


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]
                                    + SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.metric_reader(metric).read)


def test_a_metric_without_a_file_shares_its_prefix_reader():
    reader = harness.metric_reader("configs_per_s.record")
    assert reader.__file__.endswith("configs_per_s.py")
    assert harness.metric_reader("device_idle_pct.sweep").__file__ \
        .endswith("device_idle_pct.py")
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_quantity.record")


def test_the_window_ends_on_whole_draw_sets(small):
    """A window of 0 s still runs a whole draw set (3 here): every seed's
    window does the same work."""
    over = dict(small["flagship.transient"], draw_set=3)
    run = harness.new_run("flagship.transient", 5, 0.0, False,
                          overrides=over)
    import torch
    run.device = torch.device("cpu")
    run.problem = harness.build_problem(run)
    family = harness.load_module("traffic", "transient")
    family.setup(run)
    harness.run_units(run, family, time.perf_counter(), None)
    assert len(run.units) == 3
    kappas = sorted(float(u["kappa"][0]) for u in run.units)
    assert kappas == sorted(run.draws(0, 3)["kappa"].tolist())


def test_a_new_cell_config_and_metric_need_only_new_files(tmp_path, small):
    """A throwaway cell on a copy of the configuration, with a new per-layer
    metric, in a copy of the benchmark: only files added, none edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "hfbench"), root / "hfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    hb = root / "hfbench"
    shutil.copy(hb / "configs" / "geballe_no_diamond.json",
                hb / "configs" / "throwaway_stack.json")
    work = json.load(open(hb / "workloads" / "sweep.b1024.json"))
    work["config"] = "throwaway_stack"
    json.dump(work, open(hb / "workloads" / "throwaway.cell.json", "w"))
    (hb / "metrics" / "throwaway.lanes.py").write_text(
        "def read(run):\n    return sum(u['configs'] for u in run.units)\n")
    spec["configs"].append(dict(spec["configs"][1], name="throwaway_stack",
                                file="hfbench/configs/throwaway_stack.json"))
    spec["workloads"].append(dict(name="throwaway.cell",
                                  config="throwaway_stack", traffic="sweep",
                                  chips=1, why="a test's cell"))
    spec["per_layer"].append(dict(
        name="throwaway.lanes", unit="configs", better="higher",
        source="program_counter", layer="host set-up",
        moves="configs_per_s", workloads=["throwaway.cell"]))
    json.dump(spec, open(root / "BENCHMARK.json", "w"))
    line = cpu_run("throwaway.cell", small["sweep.b1024"], trace=True,
                   root=str(root))
    assert line["metrics"]["throwaway.lanes"]["value"] == 4
    assert line["correct"] is True


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace, small):
    line = cpu_run("flagship.transient", small["flagship.transient"], trace)
    keys = LINE_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert all({"name", "value", "limit"} == set(c) for c in line["checks"])
    want = {m["name"] for m in harness.cell_metrics(
        harness.new_run("flagship.transient", 0, trace=trace))}
    # a CPU run has no device trace: the device readers return nothing
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    json.dumps(line)


def test_forbidden_modules_compared_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "heatflow_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "heatflow_tpu.sim", sys)
    assert harness.forbidden_loaded() == ["heatflow_tpu.sim"]


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole run of a cell on the CPU in a fresh interpreter: no module
    whose top-level name is jax, jaxlib, flax or heatflow_tpu."""
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from hfbench import harness\n"
        "harness.run_cell('sweep.record_b256', 3, 0.1, True, 'cpu', "
        "time.perf_counter(), overrides=%r)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % (ROOT, {"size_scale": 8.0, "batch": 2}))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "heatflow_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN_MODULES)


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "hfbench/run.py", "--workload", "flagship.transient",
         "--seed", "1", "--seconds", "1", *extra], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_result_without_a_card():
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_with_only_the_benchmark(tmp_path):
    shutil.copytree(os.path.join(ROOT, "hfbench"), tmp_path / "hfbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from hfbench import harness\n"
            "harness.run_cell('flagship.transient', 1, 0.1, False, 'cpu', "
            "time.perf_counter())\n" % str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "heatflow_tpu_torch" in out.stderr
    assert _run_py(tmp_path).returncode != 0


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run(
        [sys.executable, "hfbench/run.py", "--workload", "flagship.transient",
         "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
