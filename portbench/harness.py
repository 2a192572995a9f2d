"""The benchmark's data-driven core: files found by name, one run's result.

- `BENCHMARK.json` (the checkout's root) declares the cells and metrics;
- `workloads/<cell>.json`: the cell's configuration, chips, why, driver,
  traffic parameters and correctness limits;
- `configs/<config>.json`: the configuration as it is run;
- `drivers/<kind>.py`: `run(ctx) -> Outcome`, the set-up, the window and
  the check of one kind of cell;
- `metrics/<metric>.py`: `read(data) -> number or None` of one per-layer
  metric, from what the driver collected (None: nothing to read, and the
  metric is left out of the line).

A new cell, configuration or per-layer metric is new files and entries
only: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_file(name: str, here: Path = HERE) -> dict:
    return load_json(here / "workloads" / f"{name}.json")


def config_file(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def driver(kind: str, here: Path = HERE):
    return load_module(here / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def reader(metric: str, here: Path = HERE):
    return load_module(here / "metrics" / f"{metric}.py",
                       "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))


def _applies(entry: dict, cell: str, e2e_names) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_names is None or entry.get("moves") in e2e_names


def cell_metrics(bench: dict, cell: str):
    """(end-to-end entries, per-layer entries) that the cell reports."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell, None)]
    names = {m["name"] for m in e2e}
    return e2e, [m for m in bench["per_layer"] if _applies(m, cell, names)]


@dataclass
class Ctx:
    """What a driver is given: the cell and its configuration, the run's
    seed, window length and trace switch, its device, the clock reading at
    the process's start, a scratch directory, and whether to compute the
    check's control too."""

    name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    start: float
    scratch: Path
    control: bool = False


@dataclass
class Check:
    """One number compared with its limit: correct when value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """A driver's result: the end-to-end values it measured, the data the
    per-layer readers take, the checks of correctness, the units attempted
    and failed, the device's peak memory and the trace's reading."""

    e2e: dict
    data: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict | None = None
    control_checks: list = field(default_factory=list)


def _finite(v: float) -> float:
    """v for the JSON line, where a value that is not finite (a check that
    could not be read) stands as 1e30."""
    return v if math.isfinite(v) else 1e30


def check_line(checks) -> dict:
    return {c.name: {"value": _finite(c.value), "limit": c.limit} for c in checks}


def result(outcome: Outcome, bench: dict, cell: str, trace: bool, device: dict,
           here: Path = HERE) -> dict:
    """The result's JSON object (the last line a run prints)."""
    e2e, per_layer = cell_metrics(bench, cell)
    metrics = {}
    if trace:
        for m in per_layer:
            value = reader(m["name"], here).read(outcome.data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] in outcome.e2e:
                metrics[m["name"]] = {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
    correct = bool(outcome.checks) and all(c.ok for c in outcome.checks)
    out = {"correct": correct and outcome.failed == 0,
           "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
           "device": device}
    if trace and outcome.trace is not None:
        from devtrace import breakdown

        out["breakdown"] = breakdown(outcome.trace)
    if outcome.control_checks:
        out["control_checks"] = check_line(outcome.control_checks)
    out["checks"] = check_line(outcome.checks)
    return out


def print_checks(checks, stream=sys.stderr, title="check"):
    for c in checks:
        print(f"{title} {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=stream, flush=True)
