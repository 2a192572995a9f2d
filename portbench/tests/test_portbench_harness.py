"""The harness: cells and metrics found by name from new files alone, a run
without a card refused, the no-JAX guard, and `correct` coming out false
when the timed path is broken underneath (the run's own drivers at micro
size on the CPU, the chip's look skipped)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

import pb_micro
import guard
import harness

ROOT = pb_micro.HERE.parent


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    """A workload file and a metric file dropped into a copy of the
    benchmark, with their BENCHMARK.json entries, are run by name; the
    harness's own files are the copy's, unedited."""
    tree = tmp_path / "tree"
    shutil.copytree(pb_micro.HERE, tree / "portbench", ignore=shutil.ignore_patterns(
        "_cache", "__pycache__"))
    bench = harness.benchmark()
    cell = "forecast_025.micro_pool2"
    spec = harness.cell_file("forecast_025.train_b1")
    spec["params"]["pool_pairs"] = 3
    (tree / "portbench" / "workloads" / f"{cell}.json").write_text(json.dumps(spec))
    (tree / "portbench" / "metrics" / "steps_seen.micro.py").write_text(
        "def read(data):\n    return data['s_per_step'] and 1.0 / data['s_per_step']\n")
    bench["workloads"].append({"name": cell, "config": "forecast_025", "traffic": "micro_pool2",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "steps_seen.micro", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "whole train step",
                               "moves": "s_per_step", "workloads": [cell]})
    here = tree / "portbench"
    found = harness.cell_file(cell, here)
    ctx = pb_micro.micro_ctx("forecast_025.train_b1", tmp_path, cell=found, seconds=0.5)
    ctx.name = cell
    outcome = harness.driver(found["driver"], here).run(ctx)
    out = harness.result(outcome, bench, cell, True, {"platform": "cpu"}, here)
    assert out["correct"]
    assert out["metrics"]["steps_seen.micro"]["value"] > 0
    assert "mfu.train" not in out["metrics"] or out["metrics"]["mfu.train"]["value"] > 0
    assert list(out)[-1] == "checks"


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "forecast_025.train_b1", "--seed", str(2 ** 31 + 9), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_guard_compares_top_level_names():
    names = ["vaevar_tpu_torch", "vaevar_tpu_torch.da.cycler", "vaevar_tpu.x", "jax",
             "jaxlib.xla_client", "flax.linen", "optax", "jaxtyping", "torch"]
    assert guard.refused_modules(names) == ["flax.linen", "jax", "jaxlib.xla_client", "optax",
                                            "vaevar_tpu.x"]
    assert guard.refused_modules(["vaevar_tpu_torch"]) == []


def test_guard_refuses_a_loaded_jax_package(monkeypatch, capsys):
    guard.check_no_jax()  # nothing refused is loaded by the harness and the port
    monkeypatch.setitem(sys.modules, "vaevar_tpu.x", types.ModuleType("vaevar_tpu.x"))
    with pytest.raises(SystemExit) as e:
        guard.check_no_jax()
    assert e.value.code != 0
    assert "vaevar_tpu.x" in capsys.readouterr().err


def _solve_unchanged(monkeypatch):
    from vaevar_tpu_torch.da.solver import VariationalSolver

    solve = VariationalSolver.solve
    monkeypatch.setattr(VariationalSolver, "solve",
                        lambda self, x0, bundle, **kw: solve(self, x0, bundle, **{**kw, "nit": 0}))


def _advance_unchanged(monkeypatch):
    from vaevar_tpu_torch.da import dynamics

    make = dynamics.make_integrate

    def make_integrate(model):
        integrate = make(model)
        return lambda x, steps, interpolation=False: (
            x if steps == 1 else integrate(x, steps, interpolation))

    monkeypatch.setattr(dynamics, "make_integrate", make_integrate)


def _analysis_altered(monkeypatch):
    from vaevar_tpu_torch.da.solver import VariationalSolver

    solve = VariationalSolver.solve

    def altered(self, x0, bundle, **kw):
        z, xa, diag = solve(self, x0, bundle, **kw)
        return z, xa + 1.0, diag

    monkeypatch.setattr(VariationalSolver, "solve", altered)


def _train_state_unchanged(monkeypatch):
    from vaevar_tpu_torch.train import forecast_trainer as ft

    make = ft.make_forecast_train_step

    def make_step(*args, **kw):
        init_fn, train_step = make(*args, **kw)

        def init():
            trainable, opt_state = init_fn()
            opt_state.optimizer.step = lambda: None
            return trainable, opt_state

        return init, train_step

    monkeypatch.setattr(ft, "make_forecast_train_step", make_step)


def _loss_altered(monkeypatch):
    from vaevar_tpu_torch.train import forecast_trainer as ft

    make = ft.make_forecast_train_step

    def make_step(*args, **kw):
        init_fn, train_step = make(*args, **kw)

        def altered(*a):
            trainable, opt_state, loss = train_step(*a)
            return trainable, opt_state, loss + 1.0

        return init_fn, altered

    monkeypatch.setattr(ft, "make_forecast_train_step", make_step)


FAULTS = [("vaevar_da_025.synth3dvar", _solve_unchanged),
          ("vaevar_da_025.synth3dvar", _advance_unchanged),
          ("vaevar_da_025.synth3dvar", _analysis_altered),
          ("forecast_025.train_b1", _train_state_unchanged),
          ("forecast_025.train_b1", _loss_altered)]


@pytest.mark.parametrize("cell, fault", FAULTS, ids=lambda f: getattr(f, "__name__", f))
def test_broken_timed_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    """Each fault the cell can have (one card and batch 1: no exchange
    between chips, no half batch), planted in the program underneath the
    driver, turns `correct` false; the same run without it is correct."""
    kw = {"seconds": 0.5} if cell.startswith("forecast") else {}
    for broken in (False, True):
        if broken:
            fault(monkeypatch)
        ctx = pb_micro.micro_ctx(cell, tmp_path / str(broken), **kw)
        outcome = harness.driver(ctx.cell["driver"]).run(ctx)
        out = harness.result(outcome, harness.benchmark(), cell, False, {"platform": "cpu"})
        assert out["correct"] is not broken, (fault.__name__, out["checks"])


REPORT = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/portbench"]
import run
run.environment()
import harness
outcome = harness.Outcome(e2e={}, data={}, checks=[harness.Check("gap", 0.0, 1.0)],
                          attempted=1, failed=0, memory_peak_bytes=0)
run.report(outcome, harness.benchmark(), "x.stub", True, {"platform": "cpu"})
"""


@pytest.mark.parametrize("imports", ["", "import optax\n"], ids=["plain", "refused"])
def test_guard_sees_modules_a_metric_reader_loads(imports, tmp_path):
    """The no-JAX guard runs after the per-layer readers are loaded: a reader
    dropped into a copy of the benchmark that imports a refused module (here
    a stub `optax` in the copy's root) makes the run print no result."""
    tree = tmp_path / "tree"
    shutil.copytree(pb_micro.HERE, tree / "portbench", ignore=shutil.ignore_patterns(
        "_cache", "__pycache__"))
    bench = harness.benchmark()
    bench["workloads"].append({"name": "x.stub", "config": "forecast_025", "traffic": "stub",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "stub.reader", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "setup_s", "workloads": ["x.stub"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    (tree / "optax").mkdir()
    (tree / "optax" / "__init__.py").write_text("")
    (tree / "portbench" / "metrics" / "stub.reader.py").write_text(
        imports + "def read(data):\n    return 1.0\n")
    out = subprocess.run([sys.executable, "-c", REPORT, str(tree)], capture_output=True,
                         text=True, timeout=300)
    if imports:
        assert out.returncode != 0
        assert "{" not in out.stdout
        assert "optax" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["metrics"]["stub.reader"]
