"""The port's sc4dvar path against the JAX package's: the SHT, the
control-variable transform B^1/2, the three sc4dvar costs, a micro 3D-Var
cycle, and run_da's B assets.

The B assets are the JAX package's calibrated synthetic ones on both sides
(the port's own calibration is compared apart). Fields come from numpy
seeds; the cycle and the window cost take bridged micro models as
tests/test_torch_cycle.py does.

Tolerances, with the reason:
- Clenshaw-Curtis weights and Legendre tables: bitwise, held in
  tests/test_torch_import.py (the same numpy code in float64).
- SHT analysis and synthesis at (32, 64): atol 1e-6 x max|ref| (f32 sums
  over 32 latitudes and the FFT, in another order).
- CVTransform.increment, 13- and 26-row reg_coeff: atol 1e-5 x max|ref|
  (the SHT, the regression and EOF products and the wind stencils chained;
  the channels span ~10 orders of magnitude, so the bound is on the scale of
  the largest).
- the calibrated synthetic assets: rtol 1e-4 (the calibration divides by
  the std of the port's own f32 increment); `.load`: bitwise.
- adjoint identity <Bu, y> = <u, B^T y>: rel 1e-5 (f32 sums over 5.7e5
  terms); the jvp of the linear increment against increment(u): atol 1e-6 x
  max|ref| (the same operations in another association).
- J and grad J of the three costs: J rtol 1e-5, grad J atol 1e-5 x max|ref|
  (as tests/test_torch_window.py).
- the cycle: equal iterations and evals per segment, Jb/Jo rtol 1e-3 (as
  test_torch_cycle.py), fields rtol 1e-3 with a floor of 1e-4 x the channel
  std, not 1e-5: the psi/chi -> wind stencils difference smooth fields, so
  each side's f32 increment is off an f64 one by up to 1.3e-5 (JAX) and
  8.3e-6 (port) of the channel's largest value in the wind channels, and the
  solve spreads that over every channel (observed: xa of v10 differs by
  1.8e-5 of its std where it crosses zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cycle import DA_KW, GRID, SOLVER, START, _check_cycle_against_jax
from torch_port_util import model_pair, to_np
from vaevar_tpu import channels
from vaevar_tpu import config as C
from vaevar_tpu.da import cost as jcost
from vaevar_tpu.da import cvt as jcvt
from vaevar_tpu.da import lbfgs as jlbfgs
from vaevar_tpu.da.cycler import CycledDA as JaxCycledDA
from vaevar_tpu.da.dynamics import make_integrate as jax_integrate
from vaevar_tpu.data.era5 import SyntheticEra5 as JaxEra5
from vaevar_tpu.ops import sht as jsht
from vaevar_tpu_torch.config import DAConfig as TorchDAConfig
from vaevar_tpu_torch.da import cost as tcost
from vaevar_tpu_torch.da import cvt as tcvt
from vaevar_tpu_torch.da.cycler import CycledDA as TorchCycledDA
from vaevar_tpu_torch.da.dynamics import make_integrate as torch_integrate
from vaevar_tpu_torch.data.era5 import SyntheticEra5 as TorchEra5
from vaevar_tpu_torch.ops import sht as tsht

torch.set_num_threads(1)

LOW, FULL = (32, 64), (47, 93)
FIELDS = ("len_scale", "reg_coeff", "std_sur", "vert_eig_value", "vert_eig_vec")


@pytest.fixture(scope="module")
def assets():
    return jcvt.BMatrixAssets.synthetic(scale_factor=2.0)


def _wide(b):
    """The assets with a 26-row regression (the z and u blocks)."""
    reg = np.concatenate([b.reg_coeff, 0.05 * np.random.default_rng(3).normal(
        size=(69, 13)).astype(np.float32)], axis=1)
    return jcvt.BMatrixAssets(**{**{f: getattr(b, f) for f in FIELDS}, "reg_coeff": reg})


def _pair(b, hw=LOW, out_hw=FULL, hpad=28):
    port_b = tcvt.BMatrixAssets(**{f: getattr(b, f) for f in FIELDS})
    return (jcvt.CVTransform(b, solver_hw=hw, out_hw=out_hw, hpad=hpad),
            tcvt.CVTransform(port_b, solver_hw=hw, out_hw=out_hw, hpad=hpad))


def _close(got, want, rel_to_max):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel_to_max * np.abs(want).max())


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_sht_matches_jax():
    js, ts = jsht.SHT(*LOW), tsht.SHT(*LOW)
    x = _rand((3, *LOW), 1)
    c = np.asarray(js.analysis(jnp.asarray(x)))
    _close(torch.view_as_real(ts.analysis(torch.from_numpy(x))),
           np.stack([c.real, c.imag], axis=-1), 1e-6)
    _close(ts.synthesis(torch.from_numpy(c.copy())), js.synthesis(jnp.asarray(c)), 1e-6)
    prof = _rand((5, LOW[0]), 2)
    _close(ts.zonal_coeffs(torch.from_numpy(prof)), js.zonal_coeffs(jnp.asarray(prof)), 1e-6)
    k = np.asarray(js.zonal_coeffs(jsht.gaussian_lat_kernel(20, LOW[0], np.full(3, 2.0))))
    _close(tsht.gaussian_lat_kernel(20, LOW[0], np.full(3, 2.0)),
           jsht.gaussian_lat_kernel(20, LOW[0], np.full(3, 2.0)), 1e-7)
    _close(ts.isotropic_smooth(torch.from_numpy(x), torch.from_numpy(k)),
           js.isotropic_smooth(jnp.asarray(x), jnp.asarray(k)), 1e-6)


@pytest.mark.parametrize("wide", [False, True])
def test_increment_matches_jax(assets, wide):
    jt, tt = _pair(_wide(assets) if wide else assets)
    assert tt.psi_wide == wide
    u = _rand((69, *LOW), 4)
    _close(tt.increment(torch.from_numpy(u)), jt.increment(jnp.asarray(u)), 1e-5)
    xb = _rand((69, *FULL), 5)
    _close(tt(torch.from_numpy(u), torch.from_numpy(xb)), jt(jnp.asarray(u), jnp.asarray(xb)),
           1e-5)


def test_synthetic_assets_match_jax(assets):
    raw_j = jcvt.BMatrixAssets.synthetic(scale_factor=2.0, calibrate=False)
    raw_t = tcvt.BMatrixAssets.synthetic(scale_factor=2.0, calibrate=False)
    got = tcvt.BMatrixAssets.synthetic(scale_factor=2.0)
    assert tcvt.BMatrixAssets.synthetic(scale_factor=2.0) is got  # cached
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(raw_t, f), getattr(raw_j, f), err_msg=f)
        np.testing.assert_allclose(getattr(got, f), getattr(assets, f), rtol=1e-4,
                                   atol=0, err_msg=f)
        assert getattr(got, f).dtype == np.float32


def _write_assets(root, b):
    root.mkdir(exist_ok=True)
    for f in FIELDS:
        np.save(root / f"{f}.npy", getattr(b, f))
    return str(root)


def test_load_equals_jax(assets, tmp_path):
    d = _write_assets(tmp_path / "b", assets)
    got, want = tcvt.BMatrixAssets.load(d, 3.0), jcvt.BMatrixAssets.load(d, 3.0)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_adjoint_identity_and_jvp(assets):
    _, tt = _pair(assets)
    u = torch.from_numpy(_rand((69, *LOW), 6)).requires_grad_(True)
    y = torch.from_numpy(_rand((69, *LOW), 7))
    bu = tt.increment(u)
    (bty,) = torch.autograd.grad((bu * y).sum(), u)
    lhs, rhs = float((bu.double() * y.double()).sum()), float((u.detach().double() * bty.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs), (lhs, rhs)
    w0 = torch.from_numpy(_rand((69, *LOW), 8))
    value, tangent = torch.func.jvp(tt.increment, (w0,), (u.detach(),))
    _close(tangent, bu.detach(), 1e-6)
    _close(value, tt.increment(w0), 0.0)


@pytest.fixture(scope="module")
def flow_pair():
    jm, jp, tm = model_pair(C.micro_config(img_size=LOW, attn_type="relbias"), seed=3)
    return jm, jp, tm.requires_grad_(False)


def _bundle(T, full, seed=9):
    """Physical-scale fields: background and obs about the climatology, R
    about the channel variance."""
    rr = np.random.default_rng(seed)
    m, s = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    xb = m + s * rr.normal(size=(69, *full))
    yo = xb[None] + 0.1 * s * rr.normal(size=(T, 69, *full))
    H = (rr.random((T, 69, *full)) < 0.3)
    R = (0.01 * s ** 2) * (0.5 + rr.random((T, 69, 1, 1)))
    arrs = [np.asarray(a, np.float32) for a in (xb, yo, H, R)]
    return (jcost.ObsBundle(*map(jnp.asarray, arrs)),
            tcost.ObsBundle(*map(torch.from_numpy, arrs)))


@pytest.mark.parametrize("form", ["reduced", "window_reduced", "full", "full_persistence"])
def test_costs_match_jax(assets, flow_pair, form):
    jt, tt = _pair(assets)
    jflow, jflow_p, tflow = flow_pair
    if form == "reduced":
        jb, tb = _bundle(1, FULL)
        jb, tb = jcost.reduce_obs(jb, LOW), tcost.reduce_obs(tb, LOW)
        jc = jcost.make_sc4dvar_cost_reduced(jt.increment, obs_coeff=0.7)
        tc = tcost.make_sc4dvar_cost_reduced(tt.increment, obs_coeff=0.7)
    elif form == "window_reduced":
        jb, tb = _bundle(2, FULL)
        jb, tb = jcost.reduce_obs_window(jb, LOW), tcost.reduce_obs_window(tb, LOW)
        jc = jcost.make_sc4dvar_cost_window_reduced(jt.increment, jflow.apply, da_win=2,
                                                    obs_coeff=0.7)
        tc = tcost.make_sc4dvar_cost_window_reduced(tt.increment, tflow, da_win=2,
                                                    obs_coeff=0.7)
    else:
        win = 2 if form == "full_persistence" else 1
        jb, tb = _bundle(win, FULL)
        jc = jcost.make_sc4dvar_cost(jt, da_win=win, obs_coeff=0.7)
        tc = tcost.make_sc4dvar_cost(tt, da_win=win, obs_coeff=0.7)
    params = {"flow": jflow_p}
    w = _rand((69, *LOW), 10, 0.1)
    (jcf, jts, jparts), (tcf, tts, tparts) = jc, tc
    want_j, want_g = jax.jit(jax.value_and_grad(lambda q: jcf(q, jb, params)))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    got_j = tcf(wt, tb)
    (got_g,) = torch.autograd.grad(got_j, wt)
    assert float(got_j.detach()) == pytest.approx(float(want_j), rel=1e-5)
    _close(got_g, want_g, 1e-5)
    # jitted: JAX's eager flow forward alone takes ~17 s here
    for a, b in zip(tparts(wt.detach(), tb),
                    jax.jit(lambda q: jparts(q, jb, params))(jnp.asarray(w))):
        assert float(a) == pytest.approx(float(b), rel=1e-5)
    _close(tts(wt.detach(), tb), jts(jnp.asarray(w), jb, params), 1e-6)


def test_cycle_matches_jax(assets, tmp_path):
    """One sc4dvar 3D-Var cycle: spin-up, the reduced cost through the CVT
    with min(lbfgs_iters, 5) iterations per segment, the advance. JAX runs
    zoom (its jvp-zoom program compiles slowly on the CPU); the port's
    `auto` resolves to jvp-zoom, which takes zoom's steps. The forecast
    model is a relbias micro LGUnet: the flash forecast is
    test_torch_cycle.py's, and its JAX compile would add ~13 s here."""
    jfc, jfc_p, tfc = model_pair(C.micro_config(img_size=GRID, attn_type="relbias"), seed=2)
    jt, tt = _pair(assets, hw=SOLVER, out_hw=GRID, hpad=112)
    kw = {**DA_KW, "da_mode": "sc4dvar", "lbfgs_iters": 7}
    jda = JaxCycledDA(C.DAConfig(lbfgs_linesearch="zoom", **kw), JaxEra5(hw=GRID, seed=0),
                      jax_integrate(jfc.apply), forecast_params=jfc_p, cvt=jt,
                      work_dir=str(tmp_path / "jax"), seed=0, verbose=False,
                      prefetch_obs=False)
    integrate = torch_integrate(tfc)
    tda = TorchCycledDA(TorchDAConfig(**kw), TorchEra5(hw=GRID, seed=0),
                        lambda x, steps, interp=True: integrate(x, steps, interp), cvt=tt,
                        work_dir=str(tmp_path / "port"), seed=0, verbose=False, device="cpu")
    assert tda._solver.lbfgs_iters == jda._solver._lbfgs_iters == 5
    assert tda._solver.max_segment_evals == jda._solver.max_segment_evals == 6
    calls = []
    real = jda._solver.solve
    jda._solver.solve = lambda x0, bundle, *a, **k: calls.append(bundle) or real(x0, bundle,
                                                                                 *a, **k)
    _check_cycle_against_jax(jda, tda, tmp_path, field_floor=1e-4)
    log = tda.cycle_log[0]
    # the counts are cumulative over the segments, as torch's LBFGS counts
    assert log["linesearch"] == "jvp-zoom" and max(np.diff([0] + log["n_iters"])) <= 5
    # the JAX solve's segments replayed on its own bundle: the same counts
    x = jnp.zeros((69, *SOLVER), jnp.float32)
    state, counts = jlbfgs.lbfgs_init_state(x, history=10), []
    segment = jax.jit(lambda x, st: jlbfgs.lbfgs_minimize(
        lambda q: jda._solver._cost(q, calls[0], None), x, max_iters=5, history=10,
        init_state=st, max_evals=6))
    for _ in range(DA_KW["nit"]):
        r = segment(x, state)
        x, state = r.x, r.state
        counts.append((int(r.n_iters), int(r.n_evals)))
    assert counts == list(zip(log["n_iters"], log["n_evals"]))


def test_cli_warns_without_b_files_and_reads_them(assets, tmp_path, capsys):
    from vaevar_tpu_torch import run_da

    argv = ["--device", "cpu", "--micro", "--fast_init", "--no-bf16", "--da_mode", "sc4dvar",
            "--grid", "32x64", "--solver_grid", "32x64", "--init_lag", "1", "--Nit", "2",
            "--end_time", START[:11] + "06:00:00"]
    da = run_da.main(argv + ["--coeff_dir", str(tmp_path / "none"),
                             "--work_dir", str(tmp_path / "w1")])
    err = capsys.readouterr().err
    assert "WARNING: B-matrix coefficient dir" in err and "CALIBRATED SYNTHETIC B" in err
    assert da.decoder is None and da.cycle_log[0]["linesearch"] == "jvp-zoom"
    j = [b + o for b, o in zip(da.cycle_log[0]["jb"], da.cycle_log[0]["jo"])]
    assert j[-1] < j[0] and da.cycle_log[0]["xa_finite"]
    d = _write_assets(tmp_path / "b", assets)
    da = run_da.main(argv + ["--coeff_dir", d, "--scale_factor", "3.0",
                             "--work_dir", str(tmp_path / "w2")])
    assert "WARNING" not in capsys.readouterr().err
    np.testing.assert_array_equal(da.cvt.b.len_scale, assets.len_scale * np.float32(3.0))
    assert len(da.cycle_log) == 1
