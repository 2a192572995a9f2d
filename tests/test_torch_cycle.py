"""One vae4dvar cycle of the port against the JAX package, 3D-Var and a
4D-Var window (da_win 3), and the port's CLI.

Both sides get the same bridged weights: the micro relbias VAE decoder at
32x64, the micro relbias flow model at 32x64 inside the window cost, and
the micro rope forecast model at 64x128 with flash_min_seq=16, so its
full-grid LG stage runs flash attention (the lax.scan flash on the JAX
side, the plain version on the port's CPU path). Synthetic truth, masks and
spin-up come from the same seed. The window cycle runs the zoom linesearch
on both sides (a JAX jvp-zoom window program compiles slowly on the CPU;
the port's jvp-zoom follows its zoom, tests/test_torch_jvp_zoom.py). rtol 1e-3: the cycle chains the forecast
model, the obs reduction and 2 x 4 L-BFGS iterations, each adding f32
round-off in another summation order; the optimizer takes the same
decisions, so differences stay at round-off scale amplified by the solve.
Per-channel fields also get an absolute floor of 1e-5 of the channel's
climatological std, for values that cross zero (observed: a v500 value of
-2.4e-7 m/s differs by 5.5e-9, 6e-10 of the channel std).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torch_port_util import model_pair
from vaevar_tpu import channels
from vaevar_tpu import config as C
from vaevar_tpu.da.cycler import CycledDA as JaxCycledDA
from vaevar_tpu.da.dynamics import make_integrate as jax_integrate
from vaevar_tpu.data.era5 import SyntheticEra5 as JaxEra5
from vaevar_tpu_torch.config import DAConfig as TorchDAConfig
from vaevar_tpu_torch.da.cycler import CycledDA as TorchCycledDA
from vaevar_tpu_torch.da.dynamics import make_integrate as torch_integrate
from vaevar_tpu_torch.data.era5 import SyntheticEra5 as TorchEra5

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
GRID, SOLVER = (64, 128), (32, 64)
START, END = "2022-01-01 00:00:00", "2022-01-01 06:00:00"
DA_KW = dict(nit=2, lbfgs_iters=4, init_lag=1, obs_type="free_0001",
             latent_shape=(1, 8, *SOLVER), grid_hw=GRID, solver_hw=SOLVER)
METRICS = ("bg_wrmse", "ana_wrmse", "bg_mse", "ana_mse", "bg_bias", "ana_bias")
RTOL = 1e-3


def _record(obj, name, log):
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        log.append(out)
        return out

    setattr(obj, name, wrapped)


def _port_da(work_dir, dec, fc, flow=None, coeff_dir=None, **kw):
    integrate = torch_integrate(fc)
    return TorchCycledDA(TorchDAConfig(**{**DA_KW, **kw}), TorchEra5(hw=GRID, seed=0),
                         lambda x, steps, interp=True: integrate(x, steps, interp),
                         dec, flow=flow, coeff_dir=coeff_dir, work_dir=str(work_dir), seed=0,
                         verbose=False)


@pytest.fixture(scope="module")
def models():
    dec = model_pair(C.micro_vae_configs(img_size=SOLVER)[1], seed=1)
    fc = model_pair(C.micro_config(img_size=GRID, flash_min_seq=16), seed=2)
    flow = model_pair(C.micro_config(img_size=SOLVER, attn_type="relbias"), seed=3)
    return dec, fc, flow


def _jax_da(models, work_dir, flow=False, coeff_dir=None, **kw):
    (jdec, jdec_p, _), (jfc, jfc_p, _), (jflow, jflow_p, _) = models
    return JaxCycledDA(
        C.DAConfig(lbfgs_linesearch="zoom", **{**DA_KW, **kw}), JaxEra5(hw=GRID, seed=0),
        jax_integrate(jfc.apply), forecast_params=jfc_p, decoder_apply=jdec.apply,
        vae_params=jdec_p, flow_apply=jflow.apply if flow else None,
        flow_params=jflow_p if flow else None, coeff_dir=coeff_dir, work_dir=str(work_dir), seed=0,
        verbose=False, prefetch_obs=False)


def test_one_cycle_matches_jax(models, tmp_path):
    jda = _jax_da(models, tmp_path / "jax")
    tda = _port_da(tmp_path / "port", models[0][2], models[1][2])
    _check_cycle_against_jax(jda, tda, tmp_path)


def test_window_cycle_matches_jax(models, tmp_path):
    """da_win 3: R with the synthetic Q, 3 hourly truth frames, the reduced
    window cost with 2 flow steps inside J.

    Jb and Jo per iteration hold at rtol 1e-3, but fields get a floor of
    1e-4 of the channel std, not 1e-5: under random micro weights J is
    ~4.3e9 (a background far from truth), its f32 spacing is 512 and the
    solve's whole decrease ~6e4, so the two sides' round-off in the flow
    slots' terms moves the steps slightly (observed: the analysis differs by
    up to 5.4e-5 of the channel std where it crosses zero, median 3.9e-8)."""
    jda = _jax_da(models, tmp_path / "jax", flow=True, da_win=3)
    tda = _port_da(tmp_path / "port", models[0][2], models[1][2], flow=models[2][2],
                   da_win=3, lbfgs_linesearch="zoom")
    np.testing.assert_allclose(tda.R, jda.R, rtol=0)
    assert tda.R.shape == (3, 69, 1, 1) and (tda.R[1:] > tda.R[:1]).all()
    _check_cycle_against_jax(jda, tda, tmp_path, field_floor=1e-4)
    assert tda.cycle_log[0]["linesearch"] == "zoom"


def _check_cycle_against_jax(jda, tda, tmp_path, field_floor=1e-5):
    logs = {}
    for side, da in (("jax", jda), ("port", tda)):
        logs[side] = {"spin": [], "solve": [], "ana": []}
        _record(da, "get_initial_state", logs[side]["spin"])
        _record(da._solver, "solve", logs[side]["solve"])
        _record(da, "one_step_da", logs[side]["ana"])
        logs[side]["xb_next"] = da.run_assimilation(START, END)

    def close(a, b, what, floor=0.0):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        excess = np.abs(a - b) - (RTOL * np.abs(b) + floor)
        assert excess.max() <= 0, (what, np.unravel_index(excess.argmax(), a.shape),
                                   a.flat[excess.argmax()], b.flat[excess.argmax()])

    metric_floor = field_floor * channels.STD
    field_floor = field_floor * channels.STD.reshape(-1, 1, 1)

    j, t = logs["jax"], logs["port"]
    close(t["spin"][0], j["spin"][0], "spun-up xb", field_floor)
    dj, dt = j["solve"][0][2], t["solve"][0][2]
    assert len(dt.loss_reg) == len(dj.loss_reg) == DA_KW["nit"] + 1
    close(dt.loss_reg, dj.loss_reg, "Jb per iteration")
    close(dt.loss_obs, dj.loss_obs, "Jo per iteration")
    assert dt.loss_reg[-1] > 0  # the solve moved z
    close(t["ana"][0], j["ana"][0], "xa", field_floor)
    close(t["xb_next"], jax.device_get(j["xb_next"]), "next xb", field_floor)
    for k in METRICS:
        close(np.load(tmp_path / "port" / f"{k}.npy"),
              np.load(tmp_path / "jax" / f"{k}.npy"), k,
              0.0 if k.endswith("mse") else metric_floor)


def test_resume_from_work_dir(models, tmp_path):
    (_, _, tdec), (_, _, tfc), _ = models
    first = _port_da(tmp_path, tdec, tfc)
    xb1 = first.run_assimilation(START, END)
    assert first.timings["spin_up_s"] is not None
    assert (tmp_path / "current_time.txt").read_text() == "2022-01-01 06:00:00"
    again = _port_da(tmp_path, tdec, tfc)
    starts = []
    _record(again, "one_step_da", [])
    orig = again.one_step_da
    again.one_step_da = lambda gt, xb, *a: starts.append(xb) or orig(gt, xb, *a)
    again.run_assimilation(START, "2022-01-01 12:00:00")
    assert again.timings["spin_up_s"] is None  # no second spin-up
    assert len(starts) == 1
    np.testing.assert_array_equal(starts[0].numpy(), xb1.numpy())
    assert (tmp_path / "current_time.txt").read_text() == "2022-01-01 12:00:00"
    ana = np.load(tmp_path / "ana_wrmse.npy")
    assert ana.shape == (2, 69)
    np.testing.assert_array_equal(ana[0], first.metrics_list["ana_wrmse"][0])


def _cli(tmp_path, *extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run(
        [sys.executable, "-m", "vaevar_tpu_torch.run_da", "--micro", "--fast_init",
         "--grid", "32x64", "--solver_grid", "32x64", "--init_lag", "1",
         "--end_time", END, "--work_dir", str(tmp_path), *extra],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)


def test_cli_cpu_window_completes_one_cycle(tmp_path):
    proc = _cli(tmp_path, "--device", "cpu", "--da_win", "2", "--Nit", "1")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("cycle @") == 1 and "DA complete" in proc.stdout
    assert "lbfgs_linesearch 'auto' resolves to 'jvp-zoom'" in proc.stdout
    (run,) = tmp_path.glob("run_*_win2_Nit1")
    for f in ("xb.npy", "current_time.txt", "ana_wrmse.npy", "bg_wrmse.npy"):
        assert (run / f).exists(), f
    assert np.isfinite(np.load(run / "xb.npy")).all()


def test_cli_cpu_completes_one_cycle(tmp_path):
    proc = _cli(tmp_path, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("cycle @") == 1 and "DA complete" in proc.stdout
    (run,) = tmp_path.glob("run_*")
    for f in ("xb.npy", "current_time.txt", "ana_wrmse.npy", "bg_wrmse.npy"):
        assert (run / f).exists(), f
    assert np.isfinite(np.load(run / "xb.npy")).all()


def test_cli_without_gpu_fails_clearly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = _cli(tmp_path)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
