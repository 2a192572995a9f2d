"""Run one cell of the PyTorch port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file (workloads/<cell>.json) names its configuration and the
driver that runs it (drivers/<kind>.py). The run needs as many CUDA cards
as the cell asks for and fails without them: nothing falls back to the CPU.
It warms up (set-up, reported as `setup_s` from the process's start), runs
a window of --seconds, then checks what the window produced against the
plain float32 reference (reference/) and prints the numbers compared,
each with its limit, as the last lines of standard error. The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1, read by metrics/<metric>.py), `device`, with
--trace 1 `breakdown`, and last `checks`. `--control 1` also computes the
control of the check, the reference in float8 in the program's place, and
prints its numbers under `control_checks`.

Build and kernel caches go under portbench/_cache/ (git-ignored; the nvcc
builds through VAEVAR_TORCH_BUILD_DIR); scratch files under $TMPDIR.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def environment():
    """Fixed cache directories inside the checkout, and no JAX loaded by a
    library on its own."""
    cache = HERE / "_cache"
    os.environ["VAEVAR_TORCH_BUILD_DIR"] = str(cache / "build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()
    import harness

    bench = harness.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {args.workload!r} in BENCHMARK.json")
    cell = harness.cell_file(args.workload)
    config = harness.config_file(entry["config"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        raise SystemExit(2)
    scratch = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        ctx = harness.Ctx(name=args.workload, cell=cell, config=config, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace), device="cuda",
                          start=START, scratch=scratch, control=bool(args.control))
        outcome = harness.driver(cell["driver"]).run(ctx)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes, "power_limit": power_limit()}
    if args.trace and outcome.trace is not None:
        device.update(busy_s=outcome.trace["busy_s"], window_s=outcome.trace["window_s"])
    report(outcome, bench, args.workload, bool(args.trace), device)


def report(outcome, bench, workload, trace, device):
    """Read the metrics, print the checks and, once the no-JAX guard has
    passed with every module the run loaded (the metric readers too), the
    result's line."""
    import guard
    import harness

    out = harness.result(outcome, bench, workload, trace, device)
    if outcome.control_checks:
        harness.print_checks(outcome.control_checks, title="control")
    harness.print_checks(outcome.checks)
    guard.check_no_jax()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
