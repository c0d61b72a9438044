"""The shared part of a benchmark run: finding a cell's files by name, the
host set-up of the program's problem, the measured window, the profiled
window, the comparison with the plain reference and the result line.

Nothing here names a cell, a configuration or a metric: a cell's
``hfbench/workloads/<cell>.json`` names its configuration
(``hfbench/configs/<config>.json``, whose ``mesh`` names the mesh that the
program's problem is built on: the structured grid, or a graded
triangulation) and its traffic family
(``hfbench/traffic/<family>.py``), and ``BENCHMARK.json`` names the metrics,
each read by ``hfbench/metrics/<metric>.py`` or, where no such file
exists, by the reader of its longest dotted prefix that has one
(``configs_per_s.record`` by ``configs_per_s.py``).
"""

from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

from hfbench import draws
from hfbench.reference import chipmath
from hfbench.reference import triangulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "heatflow_tpu")
BREAKDOWN_ENTRIES = 10
# the meshes a configuration file may name under its top-level ``mesh``
MESH_KINDS = ("structured", "triangulation")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = ROOT):
    """``hfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(root, "hfbench", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"hfbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: str = ROOT):
    """The reader of metric ``name``: ``hfbench/metrics/<name>.py``, else
    that of its longest dotted prefix with a file (a metric reported apart
    in some cells, under its own bound, shares its quantity's reader)."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        stem = ".".join(parts[:n])
        if os.path.isfile(os.path.join(root, "hfbench", "metrics",
                                       f"{stem}.py")):
            return load_module("metrics", stem, root)
    raise FileNotFoundError(f"no reader for metric {name!r}")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES,
    compared whole (``heatflow_tpu_torch`` is not ``heatflow_tpu``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


@dataclass
class Run:
    """One run of one cell: what the traffic family, the metric readers
    and the comparison read and write."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    device: object                    # torch.device
    spec: dict                        # BENCHMARK.json
    workload: dict                    # hfbench/workloads/<cell>.json
    config: dict                      # hfbench/configs/<config>.json
    root: str = ROOT
    overrides: dict = field(default_factory=dict)
    problem: object = None            # the program's Problem2D
    entry: object = None              # the family's callable, set in setup
    setup: dict = field(default_factory=dict)
    units: list = field(default_factory=list)
    window_s: float = 0.0
    profile: dict | None = None
    memory_peak_bytes: int = 0

    @property
    def params(self) -> dict:
        """The workload file's parameters; ``overrides`` (the tests' small
        sizes) replace them, a dict key by key."""
        out = dict(self.workload["params"])
        for k, v in self.overrides.items():
            out[k] = {**out[k], **v} if isinstance(v, dict) else v
        return out

    @property
    def cfg(self) -> dict:
        """The configuration's settings with the heating CSV's path made
        absolute."""
        cfg = json.loads(json.dumps(self.config["config"]))
        cfg["heating"]["file"] = self.heating_csv
        return cfg

    @property
    def heating_csv(self) -> str:
        return os.path.join(self.root, self.config["heating_csv"])

    @property
    def mesh(self) -> str:
        """The kind of mesh the configuration file names: its ``mesh``,
        ``{"kind": <one of MESH_KINDS>}``, or the structured grid where it
        has none. Another kind, or another key, raises."""
        spec = self.config.get("mesh", {"kind": "structured"})
        if (not isinstance(spec, dict) or set(spec) != {"kind"}
                or spec["kind"] not in MESH_KINDS):
            raise ValueError(f"mesh {spec!r}: a configuration's mesh is "
                             f"{{\"kind\": k}}, k one of "
                             f"{', '.join(MESH_KINDS)}")
        return spec["kind"]

    def recipe(self) -> dict:
        """The workload's ``recipe``: the program's own keyword arguments,
        ``dtype`` named as a torch dtype."""
        import torch
        recipe = dict(self.params["recipe"])
        recipe["dtype"] = getattr(torch, recipe["dtype"])
        return recipe

    def draws(self, start: int, count: int) -> dict:
        """The cell's coefficient draws ``start`` .. ``start + count - 1``."""
        return draws.draws(self.seed, start, count, self.params["box"],
                           int(self.params["draw_set"]))

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


def build_problem(run: Run):
    """The program's problem of the cell's configuration on the mesh its
    file names, through the port's entry points (the host set-up): the
    structured grid's ``Problem2D``, or for ``triangulation`` the graded
    non-grid triangulation's ``ProblemUnstructured``, built as ``run2d
    --mesh-style unstructured`` builds it."""
    from heatflow_tpu_torch import build_layout
    from heatflow_tpu_torch.geometry import coupler_watcher_points
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    kind = run.mesh
    cfg = run.cfg
    size_scale = run.params.get("size_scale", 1.0)
    domain, mats = build_layout(cfg)
    if kind == "triangulation":
        from heatflow_tpu_torch.mesh import unstructured_gen
        from heatflow_tpu_torch.sim import unstructured
        umesh = unstructured_gen.build_unstructured_mesh(
            domain, mats, size_scale=size_scale,
            jitter=triangulation.JITTER, seed=triangulation.SEED)
        return unstructured.build_problem_unstructured(
            umesh, HeatingCurve.from_csv(run.heating_csv), cfg,
            watcher_points=coupler_watcher_points(cfg))
    from heatflow_tpu_torch import build_structured_mesh
    from heatflow_tpu_torch.sim.problem import build_problem as build
    mesh = build_structured_mesh(domain, mats, size_scale=size_scale)
    heating = HeatingCurve.from_csv(run.heating_csv)
    return build(mesh, heating, cfg,
                 watcher_points=coupler_watcher_points(cfg))


def profiled(run: Run, body) -> dict:
    """``body()`` under torch.profiler: the device timeline (sorted (start
    us, end us, name)), the host's events, busy time (device events merged)
    and device time and calls by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        body()
        run.sync()
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        item = (s, s + e.duration_ns() / 1e3, e.name())
        (device if e.device_type() == cuda else host).append(item)
    device.sort()
    host.sort()
    kernels: dict[str, list] = {}
    for s0, s1, name in device:
        acc = kernels.setdefault(name, [0.0, 0])
        acc[0] += s1 - s0
        acc[1] += 1
    return dict(timeline=device, host=host, kernels=kernels,
                busy_us=chipmath.merged_busy((s, e) for s, e, _ in device))


def run_units(run: Run, family, deadline: float | None, count: int | None
              ) -> None:
    """Units back to back: ``count`` of them, or until the deadline has
    passed and the draws run so far (each unit's ``configs``) make whole
    draw sets, so that every seed's window does the same work. Each unit
    is timed from its call to the synchronize that ends it."""
    set_size = int(run.params["draw_set"])
    t_start = time.perf_counter()
    i = drawn = 0
    while True:
        t0 = time.perf_counter()
        rec = family.unit(run, i)
        run.sync()
        t1 = time.perf_counter()
        rec.update(t0=t0, t1=t1)
        run.units.append(rec)
        i += 1
        drawn += int(rec["configs"])
        if (count is not None and i >= count) or \
                (deadline is not None and t1 >= deadline
                 and drawn % set_size == 0):
            break
    run.window_s = time.perf_counter() - t_start


def breakdown(profile: dict) -> dict:
    """The device operations that took most time, and the longest idle
    stretches summed by what the host was doing in them: the innermost
    host event open at the stretch's middle."""
    by_op: dict[str, float] = {}
    for name, (us, _) in profile["kernels"].items():
        key = chipmath.short_name(name)
        by_op[key] = by_op.get(key, 0.0) + us / 1e6
    host = profile["host"]
    starts = [h[0] for h in host]
    gaps = sorted(chipmath.idle_gaps(profile["timeline"]),
                  key=lambda g: g[0] - g[1])[:2000]
    by_host: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label = "host: Python between profiled calls"
        k = bisect.bisect_right(starts, mid)
        for h0, h1, name in reversed(host[max(0, k - 64):k]):
            if h1 >= mid:
                label = name[:80]
                break
        by_host[label] = by_host.get(label, 0.0) + (g1 - g0) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])
                     ][:BREAKDOWN_ENTRIES]
    return dict(device_ops=top(by_op), idle_gaps=top(by_host))


def cell_metrics(run: Run) -> list[dict]:
    """The metrics of BENCHMARK.json this run reports: with --trace 0 the
    end-to-end ones, with --trace 1 the per-layer ones, each where its
    ``workloads`` names the cell or, without the key, everywhere its
    ``moves`` metric is reported."""
    e2e = [m for m in run.spec["end_to_end"]
           if run.cell in m.get("workloads", [run.cell])]
    if not run.trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in run.spec["per_layer"]
            if run.cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moved)]


def read_metrics(run: Run) -> dict:
    out = {}
    for m in cell_metrics(run):
        value = metric_reader(m["name"], run.root).read(run)
        if value is not None:
            out[m["name"]] = dict(value=float(value), unit=m["unit"])
    return out


def find_cell(spec: dict, cell: str, root: str = ROOT) -> tuple[dict, dict]:
    """(workload file, configuration file) of a cell of BENCHMARK.json."""
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    workload = load_json(os.path.join(root, "hfbench", "workloads",
                                      f"{cell}.json"))
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    if workload["config"] != entry["config"] \
            or workload["traffic"] != entry["traffic"]:
        raise ValueError(f"{cell}: the workload file names "
                         f"{workload['config']}/{workload['traffic']}, "
                         f"BENCHMARK.json {entry['config']}/"
                         f"{entry['traffic']}")
    return workload, load_json(os.path.join(root, conf["file"]))


def new_run(cell: str, seed: int, seconds: float = 0.0, trace=False,
            device=None, root: str = ROOT, overrides: dict | None = None
            ) -> Run:
    """A run of ``cell`` with its files read, nothing set up."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    workload, config = find_cell(spec, cell, root)
    return Run(cell=cell, seed=int(seed), seconds=float(seconds),
               trace=bool(trace), device=device, spec=spec,
               workload=workload, config=config, root=root,
               overrides=dict(overrides or {}))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_process: float, *, root: str = ROOT,
             overrides: dict | None = None) -> dict:
    """One run of ``cell``: set-up, the window (or with ``trace`` the
    profiled units), the comparison with the reference; returns the
    result line's object."""
    import torch
    run = new_run(cell, seed, seconds, trace, torch.device(device), root,
                  overrides)
    family = load_module("traffic", run.workload["traffic"], root)
    log(f"{cell}: {time.perf_counter() - t_process:.3f} s from the process's "
        "start to the host set-up")

    t0 = time.perf_counter()
    run.problem = build_problem(run)
    run.setup["host_s"] = time.perf_counter() - t0
    if trace and run.device.type == "cuda":
        # the profiler's first session starts CUPTI, before any CUDA graph
        # is made (CUPTI started later misses the graph's kernels) and
        # outside the window
        profiled(run, lambda: torch.ones(1, device=run.device).add_(1))
    t0 = time.perf_counter()
    if run.device.type == "cuda":
        # the port's CUDA library: built by nvcc at the first run in a
        # checkout, loaded from build/heatflow_tpu_torch/ after that
        from heatflow_tpu_torch.ops import _build
        _build.load_library()
    family.setup(run)
    run.sync()
    run.setup["device_s"] = time.perf_counter() - t0
    run.setup["total_s"] = time.perf_counter() - t_process
    log(f"{cell}: set-up {run.setup['total_s']:.3f} s (host "
        f"{run.setup['host_s']:.3f} s, device {run.setup['device_s']:.3f} s)")

    if trace:
        count = int(run.params["trace_units"])
        run.profile = profiled(
            run, lambda: run_units(run, family, None, count))
    else:
        run_units(run, family, time.perf_counter() + run.seconds, None)
    if run.device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
            run.device))
    log(f"{cell}: {len(run.units)} units in {run.window_s:.3f} s")

    # the program's state is freed before the reference runs
    run.entry = None
    run.problem.extras.clear()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    from hfbench import check
    verdict = check.judge(run)
    metrics = read_metrics(run)
    dev = dict(platform="gpu" if run.device.type == "cuda" else "cpu",
               kind=(torch.cuda.get_device_name(run.device)
                     if run.device.type == "cuda" else "cpu"),
               count=1, memory_peak_bytes=run.memory_peak_bytes)
    line = dict(correct=verdict["correct"], attempted=verdict["attempted"],
                failed=verdict["failed"], metrics=metrics, device=dev)
    if trace:
        dev["busy_s"] = run.profile["busy_us"] / 1e6
        dev["window_s"] = run.window_s
        line["breakdown"] = breakdown(run.profile)
    # the numbers compared, each beside its limit: the line's last key
    line["checks"] = verdict["checks"]
    return line
