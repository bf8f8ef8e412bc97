"""One run of one cell: set-up, the measured window, the traced phase, the
check against the reference, and the metrics.

`run_cell` finds everything by name: the cell in BENCHMARK.json, its
configuration in `configs/<config>.json`, its traffic mix in
`traffic/<traffic>.json` (whose "driver" names `drivers/<driver>.py`), the
limits of its check in `limits/<cell>.json`, and each metric's reader in
`metrics/<metric>.py`, or, where that file is not there, in the reader its
family shares, `metrics/<the name up to its first dot>.py`
(`idle_share.train` -> `metrics/idle_share.py`). A driver exposes `drive(run)`, which sets up the
program, measures, reads the memory peak (`run.read_peak()`) and frees the
program's state, and `check(run)`, which returns the compared numbers as
[(name, value, limit)]; a number passes while it is at most its limit.
"""
from __future__ import annotations

import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Optional

from .lib.spans import Spans

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (a metric's name may hold dots)."""
    path = PKG / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell: str, section: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") this cell
    reports: an end-to-end metric without `workloads` is every cell's; a
    per-layer metric names its cells."""
    if section == "per_layer":
        return [m for m in bench[section] if cell in m["workloads"]]
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    """The reader of metric `name`: metrics/<name>.py, else its family's."""
    own = PKG / "metrics" / f"{name}.py"
    return load_module("metrics", name if own.exists() else name.split(".")[0])


class Run:
    """The state of one run, read by the drivers, the checks and the
    metric readers. Host times are time.perf_counter() seconds."""

    def __init__(self, bench, cell, config, traffic, limits, seed, seconds, trace, device,
                 t_start):
        self.bench, self.cell, self.config, self.traffic = bench, cell, config, traffic
        self.arch, self.train = config["arch"], config.get("train", {})
        self.limits = limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.t_start = t_start
        self.spans = Spans()
        self.t0: Optional[float] = None      # the window's start and end
        self.t1: Optional[float] = None
        self.requests: list = []             # serving: request records
        self.deliveries: list = []           # serving: (host time, samples)
        self.pool_stats: dict = {}           # serving: pool.stats over the window
        self.steps = 0                       # training: steps in the window
        self.trace_data = None               # lib.trace.TraceData of the traced phase
        self.memory_peak_bytes = 0
        self.attempted = 0
        self.failed = 0
        self.check_state: dict = {}          # what the check needs, kept past the window
        self.info: dict = {}                 # printed to standard error, not in the result
        self.marks: list = []                # (set-up phase, host time it ended)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def setup_s(self) -> float:
        return self.t0 - self.t_start

    def mark(self, phase: str) -> None:
        """The set-up phase `phase` ends now."""
        self.marks.append((phase, time.perf_counter()))

    def setup_phases(self) -> dict:
        """Seconds of each set-up phase, each from the end of the one before
        (the first from the process's start, "rest" up to the window)."""
        out, t = {}, self.t_start
        for phase, end in self.marks + ([("rest", self.t0)] if self.t0 is not None else []):
            out[phase] = end - t
            t = end
        return out

    def read_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(max(
                torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count())))


def make_run(bench: dict, cell_name: str, seed: int, seconds: int, trace: bool, device: str,
             t_start: float, config_override: Optional[dict] = None,
             traffic_override: Optional[dict] = None) -> Run:
    """The Run of one cell, its files found by name (a test may put a
    smaller configuration or traffic in their place)."""
    import torch

    cell = find_cell(bench, cell_name)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = config_override or load_json(ROOT / cfg_entry["file"])
    traffic = dict(load_json(PKG / "traffic" / f"{cell['traffic']}.json"))
    traffic.update(traffic_override or {})
    limits = load_json(PKG / "limits" / f"{cell_name}.json")
    run = Run(bench, cell, config, traffic, limits, seed, seconds, trace, torch.device(device),
              t_start)
    run.mark("imports")
    return run


def run_cell(bench: dict, cell_name: str, seed: int, seconds: int, trace: bool, device: str,
             t_start: float, config_override: Optional[dict] = None,
             traffic_override: Optional[dict] = None) -> dict:
    """One run; returns the result line's fields, the checks, and `info`
    (readings the run prints to standard error only)."""
    import torch

    run = make_run(bench, cell_name, seed, seconds, trace, device, t_start, config_override,
                   traffic_override)
    cell = run.cell
    driver = load_module("drivers", run.traffic["driver"])
    driver.drive(run)
    checks = driver.check(run)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, cell_name, section):
        value = load_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(_passes(v, lim) for _, v, lim in checks)
    out = {
        "correct": bool(correct),
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
                   "kind": (torch.cuda.get_device_name(0) if run.device.type == "cuda"
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(run.memory_peak_bytes)},
    }
    if trace and run.trace_data is not None:
        td = run.trace_data
        out["device"]["busy_s"] = td.busy_s
        out["device"]["window_s"] = td.window_s
        out["breakdown"] = {"device_ops": td.top_ops(), "idle_gaps": td.idle_gaps()}
    steps = run.pool_stats.get("steps")
    if steps:
        run.info["pool_ms_per_step"] = {k[:-2]: 1e3 * v / steps
                                        for k, v in run.pool_stats.items() if k.endswith("_s")}
    run.info["setup_phases_s"] = run.setup_phases()
    out["info"] = run.info
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out


def _passes(value, limit) -> bool:
    return value is not None and not math.isnan(value) and value <= limit
