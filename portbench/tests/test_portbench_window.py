"""The 4D-Var window cell (`vaevar_4dvar_025.synth_win6`) at micro size on
the CPU, in float32: the plain reference of the window cost
(reference/da_window.py) against the port's reduced window cost and its
rollout, a micro run of the `da_window` driver under the cell's limits,
the float8 control and planted faults failing them, the cell's readers on
synthetic data, and its entries loaded through the harness.

Tolerances: J rtol 1e-5 and dJ/dz atol 1e-5 x max|dJ/dz| (f32 through the
decoder and five flow steps, the program's cell-centred sums against the
reference's float64 sums over the observed points); the slots' states
rtol 1e-5, atol 1e-5 x the channel's std (the same f32 arithmetic in
another order).
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

import pb_micro
import pb_micro_window as pmw
import harness
import models
from reference import channels
from reference import da as rda
from reference import da_window as rwin

SEED = 2 ** 31 + 41
NEW = ["solve_s.win", "ms_per_probe.win", "flow_share.win", "flow_recompute.win",
       "cost_drop.win", "mfu.win", "device_idle.win", "peak_mem_gib.win"]


@pytest.fixture(scope="module")
def pair():
    """(config, program decoder, program flow, reference decoder, reference
    flow) at micro size, the flow drawn from seed + 1 as the driver does."""
    cfg = pmw.micro_window_config()
    out = [cfg]
    for side in (models.program_model, models.reference_model):
        for role, seed in (("decoder", SEED), ("flow", SEED + 1)):
            m = side(cfg["models"][role], seed, "decoder", "cpu")
            out.append(m.eval().requires_grad_(False))
    return out[0], out[1], out[2], out[3], out[4]


def _window_obs(cfg, k=1):
    """The program's reduced window bundle and the reference's WindowObs of
    cycle k's column draw, on random truths."""
    from vaevar_tpu_torch.da import cost as cost_mod
    from vaevar_tpu_torch.da import obs as obs_mod

    da = cfg["da"]
    hw, low, win = tuple(da["grid_hw"]), tuple(da["solver_hw"]), da["da_win"]
    g = torch.Generator().manual_seed(7)
    mean = torch.as_tensor(channels.MEAN, dtype=torch.float32)[:, None, None]
    std = torch.as_tensor(channels.STD, dtype=torch.float32)[:, None, None]
    truths = [mean + std * torch.randn(69, *hw, generator=g) for _ in range(win)]
    xb = truths[0] + std * torch.randn(69, *hw, generator=g)
    rng = np.random.default_rng(SEED)
    masks = [obs_mod.make_obs_mask(da["obs_type"], win, hw, rng) for _ in range(k + 1)]
    cols = rda.column_draws(SEED, da["obs_type"], k + 1, hw)[k]
    assert np.array_equal(np.flatnonzero(masks[k][win - 1, 0]), cols)
    var = obs_mod.obs_error_variance(da["obs_std"], da["modify_tp"])
    q = obs_mod.load_q_matrix("/nonexistent", da["q_type"], win)
    R = torch.as_tensor(obs_mod.build_R(var, q, win))
    full = cost_mod.ObsBundle(xb=xb, yo=torch.stack(truths), H=torch.as_tensor(masks[k]), R=R)
    ref = rwin.WindowObs(truths, cols, rwin.obs_variances(da["obs_std"], da["modify_tp"], win))
    return cost_mod.reduce_obs_window(full, low), ref, xb, R


def test_obs_variances_are_the_programs_R(pair):
    cfg = pair[0]
    R = _window_obs(cfg)[3]
    da = cfg["da"]
    want = rwin.obs_variances(da["obs_std"], da["modify_tp"], da["da_win"])
    np.testing.assert_allclose(R[:, :, 0, 0].numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("zscale", [0.0, 0.3])
def test_window_cost_and_gradient_match_port(pair, zscale):
    from vaevar_tpu_torch.da import cost as cost_mod
    from vaevar_tpu_torch.da.lbfgs import value_and_grad

    cfg, dec, flow, rdec, rflow = pair
    bundle, obs, xb, _ = _window_obs(cfg)
    cost, _, parts = cost_mod.make_vae4dvar_cost_window_reduced(dec, flow, da_win=6)
    z = zscale * torch.randn(cfg["da"]["latent_shape"], generator=torch.Generator().manual_seed(5))
    ref = rwin.window_cost(rdec, rflow, z, xb, obs, grad=True)
    v, g = value_and_grad(lambda q: cost(q, bundle), z)
    assert float(v) == pytest.approx(ref["j"], rel=1e-5)
    assert float(parts(z, bundle)[1]) == pytest.approx(ref["jo"], rel=1e-5)
    torch.testing.assert_close(g, ref["grad"], rtol=0, atol=1e-5 * float(g.abs().max()))


def test_slot_states_match_window_predict(pair):
    from vaevar_tpu_torch.da import cost as cost_mod

    cfg, dec, flow, rdec, rflow = pair
    xb = _window_obs(cfg)[2]
    low = tuple(cfg["da"]["solver_hw"])
    with torch.no_grad():
        got = cost_mod._window_predict(xb, flow, low, 6)
    x = xb
    std = torch.as_tensor(channels.STD, dtype=torch.float32)[:, None, None]
    for t in range(6):
        if t:
            with torch.no_grad():
                x = rwin.flow_step(rflow, x, low)
        torch.testing.assert_close(got[t] / std, x / std, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def micro_run(tmp_path_factory):
    """One traced micro run of the window driver with the control."""
    ctx = pmw.micro_window_ctx(tmp_path_factory.mktemp("win"), control=True, trace=True)
    outcome = harness.driver(ctx.cell["driver"]).run(ctx)
    return outcome, harness.result(outcome, harness.benchmark(), pmw.CELL, True,
                                   {"platform": "cpu"})


def test_micro_run_is_correct_under_the_cells_limits(micro_run):
    outcome, out = micro_run
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(harness.cell_file(pmw.CELL)["limits"])
    assert outcome.attempted == 2 and outcome.failed == 0


# At micro size the float8 control's Jo errors come out near their limits:
# jo_gap 0.0016-0.0064 and drop_gap 0.0016-0.012 against 0.004, as the CPU's
# thread count moves the micro solve's f32 path. The other four fail by 2-8
# times on any thread count; on the card the control fails all six on every
# seed (PERF.md section 2).
CONTROL_FAILS = ["inc_gap", "grad_gap", "roll_gap", "adv_gap"]


def test_control_fails_the_limits(micro_run):
    _, out = micro_run
    failed = [k for k, c in out["control_checks"].items() if not c["value"] <= c["limit"]]
    assert set(CONTROL_FAILS) <= set(failed), out["control_checks"]


def test_micro_run_reads_the_ports_counters(micro_run):
    outcome, out = micro_run
    counts = outcome.data["counters"]
    log = outcome.data["cycle_log"]
    diag = sum(len(c["jo"]) for c in log)
    assert counts["window.rollout_steps"] == 5 * (counts["lbfgs.probes"] + diag)
    m = out["metrics"]
    assert 0 < m["flow_recompute.win"]["value"] <= 1
    assert m["cost_drop.win"]["value"] > 0
    assert m["ms_per_probe.win"]["value"] > 0
    # the CPU has no device trace and no device time of a span
    for name in ("flow_share.win", "device_idle.win", "peak_mem_gib.win"):
        assert name not in m
    steps = [s for s in outcome.data["spans"] if s["name"] == "window.step"]
    assert steps and all(s["request"] in (None, 3) for s in steps)


def _analysis_altered(monkeypatch):
    from vaevar_tpu_torch.da.solver import VariationalSolver

    solve = VariationalSolver.solve

    def altered(self, x0, bundle, **kw):
        z, xa, diag = solve(self, x0, bundle, **kw)
        return z, xa + 1.0, diag

    monkeypatch.setattr(VariationalSolver, "solve", altered)


def _flow_steps_skipped(monkeypatch):
    """The window cost's flow step returns its input: persistence in J."""
    from vaevar_tpu_torch.da import cost as cost_mod

    monkeypatch.setattr(cost_mod, "make_integrate",
                        lambda model, model_hw=None: lambda x, steps, interpolation=False: x)


def _solve_unchanged(monkeypatch):
    from vaevar_tpu_torch.da.solver import VariationalSolver

    solve = VariationalSolver.solve
    monkeypatch.setattr(VariationalSolver, "solve",
                        lambda self, x0, bundle, **kw: solve(self, x0, bundle, **{**kw, "nit": 0}))


@pytest.mark.parametrize("fault", [_analysis_altered, _flow_steps_skipped, _solve_unchanged],
                         ids=lambda f: f.__name__)
def test_broken_window_path_is_not_correct(fault, micro_run, tmp_path, monkeypatch):
    """Each fault planted in the program underneath the driver turns
    `correct` false (the fixture's run without it is correct)."""
    fault(monkeypatch)
    ctx = pmw.micro_window_ctx(tmp_path)
    outcome = harness.driver(ctx.cell["driver"]).run(ctx)
    out = harness.result(outcome, harness.benchmark(), pmw.CELL, False, {"platform": "cpu"})
    assert not out["correct"], (fault.__name__, out["checks"])


def _log(solve_s, evals=12, jvp=2, restore=1, jb=(0.0, 3.0), jo=(100.0, 60.0)):
    return {"solve_s": solve_s, "n_evals": [evals], "n_jvp": [jvp], "n_restore": [restore],
            "jb": list(jb), "jo": list(jo)}


def test_readers_on_synthetic_data():
    log = [_log(2.0), _log(4.0)]
    spans = [{"name": "solve", "device_ms": 200.0}, {"name": "window.step", "device_ms": 30.0},
             {"name": "window.step", "device_ms": 50.0}, {"name": "lbfgs.probe",
                                                          "device_ms": None}]
    data = {"cycle_log": log, "counters": {"lbfgs.probes": 24, "window.rollout_steps": 130,
                                           "window.flow_forwards": 240},
            "spans": spans, "obs_coeff": 1.0, "window_s": 10.0, "da_win": 6,
            "model_flops": {"decoder": 1e12, "flow": 2e12, "forecast": 16e12},
            "trace": {"busy_s": 3.0, "window_s": 4.0}, "peak_window_bytes": 3 * 2 ** 30,
            "harness_bytes": 2 ** 30}
    want = {"solve_s.win": 3.0, "ms_per_probe.win": 1e3 * 6.0 / 24,
            "flow_share.win": 40.0, "flow_recompute.win": 240 / 130 - 1,
            "cost_drop.win": 100.0 * (100.0 - 63.0) / 100.0,
            # per cycle: 11 values and gradients, 2 jvp probes, each of the
            # decoder and 5 flow steps (11 TFLOP), and the forecast forward
            "mfu.win": 100.0 * 2 * ((3 * 11 + 2 * 2) * 11e12 + 16e12) / (10.0 * 989e12),
            "device_idle.win": 25.0, "peak_mem_gib.win": 2.0}
    for name in NEW:
        assert harness.reader(name).read(data) == pytest.approx(want[name]), name


@pytest.mark.parametrize("name", NEW)
def test_readers_read_none_without_their_inputs(name):
    assert harness.reader(name).read({}) is None
    # a program without the window's counters or device spans (the parent's)
    parent = {"cycle_log": [_log(2.0)], "counters": {"lbfgs.probes": 12},
              "spans": [{"name": "solve", "device_ms": None}], "obs_coeff": 1.0,
              "window_s": 4.0, "da_win": 6, "model_flops": {"decoder": 1, "flow": 1,
                                                            "forecast": 1},
              "trace": None, "peak_window_bytes": 0, "harness_bytes": 0}
    got = harness.reader(name).read(parent)
    if name in ("flow_share.win", "flow_recompute.win", "device_idle.win", "peak_mem_gib.win"):
        assert got is None
    else:
        assert got is not None


def test_entries_load_through_the_harness():
    bench = harness.benchmark()
    e2e, per_layer = harness.cell_metrics(bench, pmw.CELL)
    assert sorted(m["name"] for m in e2e) == ["s_per_cycle", "setup_s"]
    assert [m["name"] for m in per_layer] == NEW
    assert all(m["moves"] == "s_per_cycle" and m["workloads"] == [pmw.CELL] for m in per_layer)
    entry = next(w for w in bench["workloads"] if w["name"] == pmw.CELL)
    assert entry["chips"] == 1 and entry["config"] == "vaevar_4dvar_025"
    config = next(c for c in bench["configs"] if c["name"] == "vaevar_4dvar_025")
    cfg = harness.config_file("vaevar_4dvar_025")
    assert cfg["reduced"] == config["reduced"] and config["file"].endswith(
        "configs/vaevar_4dvar_025.json")
    da3 = harness.config_file("vaevar_da_025")
    assert cfg["models"]["forecast"] == da3["models"]["forecast"]
    assert cfg["models"]["decoder"] == dict(da3["models"]["decoder"], remat=True)
    assert cfg["da"] == dict(da3["da"], da_win=6, nit=1, window_step_checkpoint=True)
    assert harness.cell_file(pmw.CELL)["driver"] == "da_window"
    assert hasattr(harness.driver("da_window"), "run")
    for name in NEW:
        assert hasattr(harness.reader(name), "read")


def test_flow_entry_is_the_ports_flow_140():
    from vaevar_tpu_torch import config as cfgs

    prog = models.program_config(harness.config_file("vaevar_4dvar_025")["models"]["flow"])
    assert prog == cfgs.FLOW_140.replace(dtype=torch.bfloat16, remat=True)


def test_window_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, 'portbench'); "
            "import reference.da_window; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('vaevar_tpu', 'vaevar_tpu_torch', 'jax', 'jaxlib', 'flax', 'optax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=pb_micro.HERE.parent,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
