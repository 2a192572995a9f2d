"""The rest of the DA surface on the port against the JAX package: a micro
cycle with real observations, the free_run and interpolation baselines,
init_tp 2, the eval holdout (error_obs), the per-cycle dumps and
forecast_eval, and run_da's flags on the CPU (the prepbufr cycles are in
tests/test_torch_prepbufr.py, which shares this file's set-up).

Both packages get the same bridged micro models, as
tests/test_torch_cycle.py builds them: the relbias micro VAE decoder at
16x32 under a 32x64 analysis grid and a relbias micro forecast model at
32x64 (the flash forecast is test_torch_cycle.py's). Truth, masks and
reports come from the same seeds; the synthetic station network is the
same in one process (its noise, 0 here, would seed from hash()). JAX runs
the zoom linesearch (its jvp-zoom program compiles slowly on the CPU);
the port's `auto` resolves to jvp-zoom, which takes zoom's steps
(tests/test_torch_jvp_zoom.py), and the JAX segments are replayed on their
own bundle to count their iterations and evals.

Tolerances, with the reason:
- cycles: equal iterations and evals per segment; Jb, Jo, fields and
  metrics rtol 1e-3 with a floor of 1e-5 x the channel std on fields, as
  test_torch_cycle.py (the decoder, the augmentation and 2 x 4 L-BFGS
  iterations chained in another summation order); error_obs rtol 1e-3 (the
  analysis' round-off, summed over the held-out cells);
- obs of the cycle (yo, H, R, the truth): bitwise for the station mask and
  the synthetic families, H of real obs equal (QC flips none here), R of
  real obs rtol 1e-6 and yo atol 1e-6 x the channel's largest |value| (an
  ulp of the augmentation's terms, tests/test_torch_real_obs.py);
- free_run and init_tp 2: the background, the analysis and the truth dumps
  bitwise (no arithmetic: the truth frames, or the background itself), the
  first cycle's metrics rtol 1e-6 with a floor of 1e-6 x the channel std
  (f32 scoring sums in another order); forecast_wrmse rtol 1e-3 with the
  metrics' floor (the forecast model);
- interpolation_analysis: rtol 1e-6 with an absolute floor of 1e-6 x the
  channel std: scipy's griddata on the same points and values, and with
  real obs the background augmented by each package in f32 (an ulp of the
  augmentation's terms) and mapped back by the same numpy einsum.
"""

import json
import os
import subprocess
import sys
from datetime import datetime, timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_cycle import _check_cycle_against_jax, _record
from torch_port_util import model_pair
from vaevar_tpu import channels
from vaevar_tpu import config as C
from vaevar_tpu.da import baselines as jbase
from vaevar_tpu.da import lbfgs as jlbfgs
from vaevar_tpu.da.cycler import CycledDA as JaxCycledDA
from vaevar_tpu.da.dynamics import make_integrate as jax_integrate
from vaevar_tpu.ops import interp as jinterp
from vaevar_tpu.data import reports as jreports
from vaevar_tpu.data.era5 import SyntheticEra5 as JaxEra5
from vaevar_tpu_torch.config import DAConfig as TorchDAConfig
from vaevar_tpu_torch.da import baselines as tbase
from vaevar_tpu_torch.da.cycler import CycledDA as TorchCycledDA
from vaevar_tpu_torch.da.dynamics import make_integrate as torch_integrate
from vaevar_tpu_torch.data import reports as treports
from vaevar_tpu_torch.data.era5 import SyntheticEra5 as TorchEra5

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
GRID, SOLVER = (32, 64), (16, 32)
START, END = "2022-01-01 00:00:00", "2022-01-01 06:00:00"
DA_KW = dict(nit=2, lbfgs_iters=4, init_lag=1, init_tp=1, latent_shape=(1, 8, *SOLVER),
             grid_hw=GRID, solver_hw=SOLVER)
METRICS = ("bg_wrmse", "ana_wrmse", "bg_mse", "ana_mse", "bg_bias", "ana_bias")
N_STATIONS = 400


@pytest.fixture(scope="module")
def models():
    dec = model_pair(C.micro_vae_configs(img_size=SOLVER)[1], seed=1)
    fc = model_pair(C.micro_config(img_size=GRID, attn_type="relbias"), seed=2)
    return dec, fc


class _Twice(torch.nn.Module):
    """A flow model that returns its input twice (mean and logvar heads):
    the window's slots see the persisted state, cheaply on both sides."""

    def forward(self, z):
        return torch.cat([z, z], 1)


def _pair(models, tmp_path, da_win=1, dt=(0.0, 0.0), **kw):
    """(JAX cycler, port cycler) on the same config, truth and reports."""
    (jdec, jdec_p, tdec), (jfc, jfc_p, tfc) = models
    kw = {**DA_KW, "da_win": da_win, **kw}
    flow = da_win > 1 and kw.get("da_mode", "vae4dvar") == "vae4dvar"
    station = kw.get("obs_type", "").startswith(("real", "prepbufr"))
    jsrc, tsrc = JaxEra5(hw=GRID, seed=0), TorchEra5(hw=GRID, seed=0)
    extra = {k: kw.pop(k) for k in ("save_field", "save_gt", "save_obs", "forecast_eval",
                                    "forecast_eval_steps", "obs_from_numpy", "mask_dir")
             if k in kw}
    jda = JaxCycledDA(
        C.DAConfig(lbfgs_linesearch="zoom", **kw), jsrc, jax_integrate(jfc.apply),
        forecast_params=jfc_p, decoder_apply=jdec.apply, vae_params=jdec_p,
        flow_apply=(lambda p, z: jnp.concatenate([z, z], 1)) if flow else None,
        reports_source=jreports.SyntheticReports(jsrc, N_STATIONS, seed=3, dt_range=dt)
        if station else None,
        work_dir=str(tmp_path / "jax"), seed=0, verbose=False, prefetch_obs=False, **extra)
    integrate = torch_integrate(tfc)
    tda = TorchCycledDA(
        TorchDAConfig(**kw), tsrc, lambda x, steps, interp=True: integrate(x, steps, interp),
        tdec if kw.get("da_mode", "vae4dvar") == "vae4dvar" else None,
        flow=_Twice() if flow else None,
        reports_source=treports.SyntheticReports(tsrc, N_STATIONS, seed=3, dt_range=dt)
        if station else None,
        work_dir=str(tmp_path / "port"), seed=0, verbose=False, device="cpu", **extra)
    return jda, tda


def _close(got, want, rtol=1e-3, floor=0.0):
    """|got - want| <= rtol |want| + floor, elementwise (floor broadcasts)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    excess = np.abs(got - want) - (rtol * np.abs(want) + floor)
    assert excess.max() <= 0, (np.unravel_index(excess.argmax(), got.shape),
                               got.flat[excess.argmax()], want.flat[excess.argmax()])


def _counts_of_jax_solve(jda, bundle):
    """(iterations, evals) per segment of the JAX solve, replayed on its bundle."""
    cfg, solver = jda.cfg, jda._solver
    x = jnp.zeros(cfg.latent_shape, jnp.float32)
    state, counts = jlbfgs.lbfgs_init_state(x, history=cfg.lbfgs_history), []
    segment = jax.jit(lambda x, st: jlbfgs.lbfgs_minimize(
        lambda q: solver._cost(q, bundle, jda._params), x, max_iters=solver._lbfgs_iters,
        history=cfg.lbfgs_history, init_state=st, max_evals=solver.max_segment_evals))
    for _ in range(cfg.nit):
        r = segment(x, state)
        x, state = r.x, r.state
        counts.append((int(r.n_iters), int(r.n_evals)))
    return counts


def _solve_cycle_matches_jax(jda, tda, tmp_path, counts=True):
    """The cycle against JAX (test_torch_cycle.py's checks); with `counts`,
    also the iterations and evals of every segment."""
    bundles, obs = [], {"jax": [], "port": []}
    real = jda._solver.solve
    jda._solver.solve = lambda x0, b, *a, **k: bundles.append(b) or real(x0, b, *a, **k)
    _record(jda, "get_obs_info", obs["jax"])
    _record(tda, "get_obs_info", obs["port"])
    _check_cycle_against_jax(jda, tda, tmp_path)
    log = tda.cycle_log[0]
    assert log["linesearch"] == "jvp-zoom"
    if counts:
        assert _counts_of_jax_solve(jda, bundles[0]) == list(zip(log["n_iters"],
                                                                 log["n_evals"]))
    return obs["jax"][0], obs["port"][0], log


def test_real_simu_eval_cycle_matches_jax(models, tmp_path):
    """real_simu with use_eval: reports gridded onto 204 channels, QC'd,
    replaced by the augmented truth, 20 % of the cells held out; the
    full-grid cost with the augmentation inside J.

    obs_std 0.05, not the default 0.005: there Jo is ~1.4e8 and the micro
    decoder lowers it by ~5e3 (3.5e-5 of J), so the linesearch interpolates
    values a few f32 ulps apart; the counts still agree with JAX, but the
    second segment's Jb moves by 0.5 %, and by 0.18 % in the port against
    itself on 4 threads instead of 1 (the same f32 sums in another order)."""
    jda, tda = _pair(models, tmp_path, obs_type="real_simu", use_eval=True, obs_std=0.05)
    assert not tda._reducible and tda._reduce_obs is None
    np.testing.assert_array_equal(tda.mask_eval, jda.mask_eval)
    np.testing.assert_allclose(tda.R_aug, jda.R_aug, rtol=1e-6)
    (jyo, jH, jR, jgt), (tyo, tH, tR, tgt), log = _solve_cycle_matches_jax(jda, tda, tmp_path)
    assert tyo.shape == (1, 204, *GRID) and tR.shape == (1, 204, 1, 1)
    np.testing.assert_array_equal(tH.numpy(), np.asarray(jH))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jgt))
    jyo = np.asarray(jyo)
    _close(tyo.numpy(), jyo, 0, 1e-6 * np.abs(jyo).max(axis=(0, 2, 3), keepdims=True))
    assert 0 < log["n_kept"] <= log["n_gridded"] and log["n_kept"] == float(np.asarray(jH).sum())
    err_t = np.load(tmp_path / "port" / "error_obs.npy")
    err_j = np.load(tmp_path / "jax" / "error_obs.npy")
    assert err_t.shape == err_j.shape == (1, 204)
    np.testing.assert_allclose(err_t, err_j, rtol=1e-3)
    assert np.isfinite(err_t).all() and (err_t > 0).any()


def test_free_run_dumps_and_forecast_eval_match_jax(models, tmp_path):
    """free_run over 2 cycles with real_simu obs and the holdout: no solve,
    error_obs of the background, every dump, and 2-lead forecast scores."""
    kw = dict(da_mode="free_run", obs_type="real_simu", use_eval=True, save_field=True,
              save_gt=True, save_obs=True, forecast_eval=True, forecast_eval_steps=2)
    jda, tda = _pair(models, tmp_path, **kw)
    assert tda._solver is None
    jda.run_assimilation(START, "2022-01-01 12:00:00")
    tda.run_assimilation(START, "2022-01-01 12:00:00")
    j, t = tmp_path / "jax", tmp_path / "port"
    for stamp in ("2022-01-01_00:00:00", "2022-01-01_06:00:00"):
        for name in ("xb", "xa", "gt"):
            got, want = np.load(t / f"{name}_{stamp}.npy"), np.load(j / f"{name}_{stamp}.npy")
            if stamp.endswith("06:00:00") and name != "gt":
                _close(got, want, 1e-3, 1e-5 * channels.STD.reshape(-1, 1, 1))
            else:
                np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.load(t / f"xa_{stamp}.npy"),
                                      np.load(t / f"xb_{stamp}.npy"))
        obs_t, obs_j = np.load(t / f"obs_{stamp}.npy"), np.load(j / f"obs_{stamp}.npy")
        assert obs_t.shape == (1, 204, *GRID)
        _close(obs_t, obs_j, 0, 1e-6 * np.abs(obs_j).max(axis=(0, 2, 3), keepdims=True))
    fw_t, fw_j = np.load(t / "forecast_wrmse.npy"), np.load(j / "forecast_wrmse.npy")
    assert fw_t.shape == fw_j.shape == (2, 2, 69)
    _close(fw_t, fw_j, 1e-3, 1e-5 * channels.STD)
    for k in (*METRICS, "error_obs"):
        _close(np.load(t / f"{k}.npy"), np.load(j / f"{k}.npy"), 1e-3,
               0 if k.endswith(("mse", "obs")) else 1e-5 * channels.STD)
    np.testing.assert_array_equal(np.load(t / "ana_wrmse.npy"), np.load(t / "bg_wrmse.npy"))
    assert [c["jb"] for c in tda.cycle_log] == [[], []]


def test_init_tp2_spin_up_matches_jax(models, tmp_path):
    """init_tp 2 starts from the truth 183 days before the start."""
    jda, tda = _pair(models, tmp_path, da_mode="free_run", obs_type="free_0001", init_tp=2)
    start = datetime(2022, 1, 1)
    got = tda.get_initial_state(start).numpy()
    np.testing.assert_array_equal(got, np.asarray(jda.get_initial_state(pd.Timestamp(start))))
    np.testing.assert_array_equal(got, TorchEra5(hw=GRID, seed=0).get_state(
        start - timedelta(days=183)))
    jda.run_assimilation(START, END)
    tda.run_assimilation(START, END)
    for k in METRICS:  # f32 scoring sums in another order
        _close(np.load(tmp_path / "port" / f"{k}.npy"), np.load(tmp_path / "jax" / f"{k}.npy"),
               1e-6, 0 if k.endswith("mse") else 1e-6 * channels.STD)


def test_interpolation_cycle_matches_jax(models, tmp_path):
    """interpolation with real_simu obs and the holdout: griddata per
    augmented channel on the host, mapped back to 69 channels."""
    jda, tda = _pair(models, tmp_path, da_mode="interpolation", obs_type="real_simu",
                     use_eval=True)
    for da in (jda, tda):
        da.run_assimilation(START, END)
    for k in (*METRICS, "error_obs"):
        _close(np.load(tmp_path / "port" / f"{k}.npy"), np.load(tmp_path / "jax" / f"{k}.npy"),
               1e-3, 0 if k.endswith(("mse", "obs")) else 1e-5 * channels.STD)
    ana, bg = (np.load(tmp_path / "port" / f"{k}.npy") for k in ("ana_wrmse", "bg_wrmse"))
    assert not np.array_equal(ana, bg)  # the interpolation changed the field


@pytest.mark.parametrize("real_obs", [False, True])
def test_interpolation_analysis_matches_jax(real_obs):
    rr = np.random.default_rng(4)
    m, s = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    hw, c_obs = (24, 48), 204 if real_obs else 69
    xb = (m + s * rr.standard_normal((69, *hw))).astype(np.float32)
    H = (rr.random((c_obs, *hw)) < 0.15).astype(np.float32)
    H[5] = 0  # a channel with no obs keeps the background
    yo = m + s * rr.standard_normal((69, *hw))
    if real_obs:  # the truth on the observation levels, in float64 numpy
        lv = jinterp.obs_level_interp_matrix(40).astype(np.float64)
        yo = np.concatenate([yo[:4]] + [np.einsum("lk,khw->lhw", lv, yo[4 + 13 * i:17 + 13 * i])
                                        for i in range(5)])
    yo = yo.astype(np.float32)
    got = tbase.interpolation_analysis(xb, yo, H, real_obs=real_obs)
    want = jbase.interpolation_analysis(xb, yo, H, real_obs=real_obs)
    assert got.shape == want.shape == (69, *hw)
    _close(got, want, 1e-6, 1e-6 * s)
    if not real_obs:
        np.testing.assert_array_equal(got[5], xb[5])


def _cli(tmp_path, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run(
        [sys.executable, "-m", "vaevar_tpu_torch.run_da", "--device", "cpu", "--micro",
         "--fast_init", "--grid", "32x64", "--solver_grid", "32x64", "--init_lag", "1",
         "--end_time", END, "--work_dir", str(tmp_path), *extra],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)


def test_cli_real_simu_flags(tmp_path):
    """The README's real-obs recipe at micro size, with every dump flag and
    a prefix naming the work dir."""
    proc = _cli(tmp_path, "--obs_type", "real_simu", "--use_eval", "--prefix", "exp7",
                "--n_stations", "300", "--interp_dim", "40", "--save_field", "--save_gt",
                "--save_obs", "--forecast_eval", "--forecast_eval_steps", "2")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "lbfgs_linesearch 'auto' resolves to 'jvp-zoom'" in proc.stdout
    (run,) = tmp_path.glob("exp7_stdmodify2_real_simu_std0.005_win1_Nit4")
    stamp = "2022-01-01_00:00:00"
    assert np.load(run / "error_obs.npy").shape == (1, 204)
    assert np.load(run / "forecast_wrmse.npy").shape == (1, 2, 69)
    assert np.load(run / f"obs_{stamp}.npy").shape == (1, 204, 32, 64)
    for name in ("xb", "xa", "gt"):
        assert np.isfinite(np.load(run / f"{name}_{stamp}.npy")).all(), name


def _main(tmp_path, *extra):
    from vaevar_tpu_torch import run_da

    return run_da.main(["--device", "cpu", "--micro", "--fast_init", "--grid", "32x64",
                        "--solver_grid", "32x64", "--init_lag", "1", "--end_time", END,
                        "--work_dir", str(tmp_path / "work"), *extra])


def test_cli_modes_and_inputs(tmp_path):
    """free_run on prepbufr at da_win 6, interpolation with a --mask_eval
    file, real obs from --reports_dir and from --obs_from_numpy, init_tp 2:
    each completes one cycle and writes its outputs."""
    da = _main(tmp_path, "--da_mode", "free_run", "--obs_type", "prepbufr", "--da_win", "6",
               "--init_tp", "2", "--prefix", "fr")
    assert da.flow is None and da.decoder is None
    assert da.last_obs_info["n_gridded"] > 0 and len(da.cycle_log) == 1
    assert os.path.basename(da.work_dir).startswith("fr_stdmodify2_prepbufr")

    mask = (np.random.default_rng(0).random((204, 32, 64)) < 0.5).astype(np.float32)
    np.save(tmp_path / "mask_eval.npy", mask)
    da = _main(tmp_path, "--da_mode", "interpolation", "--obs_type", "real_simu", "--use_eval",
               "--mask_eval", str(tmp_path / "mask_eval.npy"))
    np.testing.assert_array_equal(da.mask_eval, mask)
    assert np.load(Path(da.work_dir) / "error_obs.npy").shape == (1, 204)

    reports = treports.SyntheticReports(TorchEra5(hw=(32, 64), seed=0), n_stations=300,
                                        seed=9).get_reports(datetime(2022, 1, 1))
    (tmp_path / "reports").mkdir()
    json.dump(reports, open(tmp_path / "reports" / "2022-01-01_00.json", "w"))
    da = _main(tmp_path, "--obs_type", "real_simu", "--reports_dir", str(tmp_path / "reports"),
               "--prefix", "rep")
    assert da.last_obs_info["n_kept"] > 0 and da.cycle_log[0]["xa_finite"]

    d = tmp_path / "npyobs" / "2022"
    d.mkdir(parents=True)
    rr = np.random.default_rng(1)
    np.save(d / "2022-01-01T00-obs.npy", rr.normal(size=(1, 204, 32, 64)).astype(np.float32))
    np.save(d / "2022-01-01T00-mask.npy", (rr.random((1, 204, 32, 64)) < 0.05).astype(np.float32))
    da = _main(tmp_path, "--obs_type", "real_simu_nofiltering", "--obs_from_numpy",
               str(tmp_path / "npyobs"), "--prefix", "npy")
    assert da.last_obs_info["n_kept"] == da.last_obs_info["n_gridded"] > 0
    with pytest.raises(SystemExit, match="no such file"):
        _main(tmp_path, "--obs_type", "real_simu", "--reports_dir", str(tmp_path / "absent"))
