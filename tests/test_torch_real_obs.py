"""The port's real-observation pipeline against the JAX package: the level
ladder and interpolation matrices, `augment_levels`, `resize_bilinear`,
station gridding (prepbufr masks and real-obs values), pre-gridded obs
files, the report sources, QC, mask files, and the full-grid cost on the
204 augmented channels.

Inputs come from numpy seeds; the report dictionaries are built here, with
malformed rows, numpy scalars and reports for every window slot of both
report files. The costs take bridged micro models as
tests/test_torch_window.py does.

Tolerances, with the reason:
- the level ladder, the interpolation matrices and their inverse, the
  station and real-obs gridding, the augmented std, the numpy obs files and
  the synthetic reports: bitwise (the same numpy code in float64/float32);
- `augment_levels`: rtol 1e-6 on the scale of its terms, sum_k |m_lk x_k|:
  each output is a sum of at most two products, which XLA and torch may
  fuse into an FMA differently, so an output that cancels to near zero
  differs by an ulp of its terms, not of itself;
- `resize_bilinear`: the weights bitwise equal to the reference's at these
  sizes (both computed in float32 in the same steps; a downsampling by 5 or
  more sums its kernel taps in another order, ~3e-8 at 721 -> 128); the
  output atol 1e-6 against the float64 product with those weights, up and
  down, and atol 2e-5 against JAX's own output, whose CPU contraction is
  itself ~7e-6 off that float64 product at 32x64 -> 90x180 (values of
  N(0, 1) up to ~4);
- `qc_filter`: the keep masks equal, each package QC-ing against its own
  augmented truth; a value within an ulp of the threshold could flip a keep
  bit, and none does on this data (0 flips allowed);
- J of the real-obs full cost rtol 1e-5, dJ atol 1e-5 x max|dJ| (vae4dvar
  at da_win 1 and at da_win 3 with the flow model inside J, sc4dvar at
  da_win 1): f32 through the decoder or the CVT, the flow steps and the
  augmentation in another summation order, as tests/test_torch_window.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from torch_port_util import model_pair, to_np
from vaevar_tpu import channels
from vaevar_tpu import config as C
from vaevar_tpu.da import cost as jcost
from vaevar_tpu.da import cvt as jcvt
from vaevar_tpu.da import obs as jobs
from vaevar_tpu.data import reports as jreports
from vaevar_tpu.data.era5 import SyntheticEra5 as JaxEra5
from vaevar_tpu.ops import interp as jinterp
from vaevar_tpu_torch.da import cost as tcost
from vaevar_tpu_torch.da import obs as tobs
from vaevar_tpu_torch.data import reports as treports
from vaevar_tpu_torch.data.era5 import SyntheticEra5 as TorchEra5
from vaevar_tpu_torch.ops import interp as tinterp

torch.set_num_threads(1)
LOW, FULL = (16, 32), (47, 93)
C_OBS = 4 + 5 * 40


def _state(seed, shape):
    """Physical states: channel mean + std * N(0, 1)."""
    rr = np.random.default_rng(seed)
    m, s = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    return (m + s * rr.standard_normal(shape)).astype(np.float32)


def _reports(seed, n=400, dt=(-3.5, 3.5)):
    """Station reports in the reference's format, with every kind of row the
    gridding must skip or take: None and non-finite positions, short lists,
    non-dict rows, numpy scalars, a bool, falsy values, invalid pressures."""
    rr = np.random.default_rng(seed)
    levels = np.asarray(channels.PRESSURE_LEVELS, np.float64)
    out = {}
    for i in range(n):
        p = float(rr.choice(levels)) * float(rr.uniform(0.9, 1.1))
        val = [p, float(rr.normal(5000, 500)), float(rr.normal(3000, 100)),
               float(rr.normal(0, 8)), float(rr.normal(0, 8)), float(rr.normal(0, 20)),
               None, float(rr.normal(1010, 10))]
        for k in rr.choice(8, size=2, replace=False):
            if k not in (0, 6) and rr.random() < 0.3:
                val[k] = 0 if rr.random() < 0.5 else None
        pos = [float(rr.uniform(0, 360)), float(rr.uniform(-90, 90)), p,
               float(rr.uniform(*dt))]
        if i % 7 == 0:
            pos = [np.float32(v) for v in pos]
        out[f"s{i}"] = {"position": pos, "value": val}
    out.update({
        "bad_none_pos": {"position": [None, 10.0, 500.0, 0.0], "value": [500.0] + [1.0] * 7},
        "bad_nan_pos": {"position": [10.0, np.nan, 500.0, 0.0], "value": [500.0] + [1.0] * 7},
        "bad_inf_dt": {"position": [10.0, 10.0, 500.0, np.inf], "value": [500.0] + [1.0] * 7},
        "bad_short_pos": {"position": [10.0, 10.0, 500.0], "value": [500.0] + [1.0] * 7},
        "bad_short_val": {"position": [10.0, 10.0, 500.0, 0.0], "value": [500.0, 1.0]},
        "bad_bool_pos": {"position": [True, 10.0, 500.0, 0.0], "value": [500.0] + [1.0] * 7},
        "bad_not_dict": [1, 2, 3],
        "bad_keys": {"pos": [10.0, 10.0, 500.0, 0.0], "val": [500.0] + [1.0] * 7},
        "bad_pressure_zero": {"position": [20.0, 20.0, 500.0, 0.0], "value": [0.0] + [1.0] * 7},
        "bad_pressure_none": {"position": [20.0, 20.0, 500.0, 0.0],
                              "value": [None] + [1.0] * 7},
        "bad_pressure_bool": {"position": [20.0, 20.0, 500.0, 0.0],
                              "value": [True] + [1.0] * 7},
        "bad_pressure_nan": {"position": [20.0, 20.0, 500.0, 0.0],
                             "value": [np.nan] + [1.0] * 7},
        "edge_lon_360": {"position": [359.99, -90.0, 1000.0, 0.2], "value": [1000.0] + [2.0] * 7},
        "np_value": {"position": [30.0, 30.0, 850.0, 0.0],
                     "value": [np.float32(850.0), np.float64(1400.0), np.float32(4000.0),
                               np.float32(1.5), np.float32(-2.0), np.float32(3.0), None,
                               np.float32(1000.0)]},
    })
    return out


@pytest.mark.parametrize("dim_out", [40, 13, 20])
def test_levels_and_interp_matrices_bitwise(dim_out):
    np.testing.assert_array_equal(tinterp.obs_height_levels(dim_out),
                                  jinterp.obs_height_levels(dim_out))
    for name in ("obs_level_interp_matrix", "obs_level_interp_matrix_inv"):
        got, want = getattr(tinterp, name)(dim_out), getattr(jinterp, name)(dim_out)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tobs.std_layer_augmented(dim_out),
                                  jobs.std_layer_augmented(dim_out))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_augment_levels(lead):
    x = _state(1, (*lead, 69, 12, 20))
    m = jinterp.obs_level_interp_matrix(40)
    want = np.asarray(jinterp.augment_levels(jnp.asarray(x), m))
    got = tinterp.augment_levels(torch.from_numpy(x), m).numpy()
    assert got.shape == want.shape == (*lead, C_OBS, 12, 20)
    scale = np.abs(np.asarray(jinterp.augment_levels(jnp.asarray(np.abs(x)), np.abs(m))))
    assert np.all(np.abs(got - want) <= 1e-6 * scale)
    np.testing.assert_array_equal(got[..., :4, :, :], x[..., :4, :, :])


def _reference_resize_weights(n_in, n_out):
    """The reference's weight matrix along one axis, from jax.image's own
    weight function with its bilinear kernel (its resize output cannot give
    them back exactly: the CPU contraction itself rounds at ~6e-6)."""
    from jax._src.image import scale as jscale

    return np.asarray(jscale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, jscale._kernels[jax.image.ResizeMethod.LINEAR], True))


@pytest.mark.parametrize("out_hw", [(90, 180), (47, 93), (64, 128), (16, 32), (13, 29)])
def test_resize_bilinear(out_hw):
    x = np.random.default_rng(2).standard_normal((2, 3, 32, 64)).astype(np.float32)
    for n_in, n_out in ((32, out_hw[0]), (64, out_hw[1])):
        np.testing.assert_array_equal(tinterp._bilinear_weights(n_in, n_out),
                                      _reference_resize_weights(n_in, n_out))
    got = tinterp.resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    exact = np.einsum("bchw,hi,wj->bcij", x.astype(np.float64),
                      tinterp._bilinear_weights(32, out_hw[0]).astype(np.float64),
                      tinterp._bilinear_weights(64, out_hw[1]).astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    want = np.asarray(jinterp.resize_bilinear(jnp.asarray(x), out_hw))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("da_win", [1, 6])
def test_station_mask_bitwise(da_win):
    hw = (32, 64)
    first, second = _reports(3), _reports(4)
    want = jobs.station_mask_from_reports(first, da_win, hw)
    got = tobs.station_mask_from_reports(first, da_win, hw)
    if da_win > 3:
        want = jobs.station_mask_from_reports(second, da_win, hw, second_file=True, H_out=want)
        got = tobs.station_mask_from_reports(second, da_win, hw, second_file=True, H_out=got)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (da_win, 69, *hw) and got.sum() > 0
    if da_win == 6:  # both files put reports into their slots
        assert all(got[t].sum() > 0 for t in range(6))


@pytest.mark.parametrize("da_win, dt", [(1, (-3.5, 3.5)), (3, (-0.5, 2.4)), (6, (-3.5, 3.5))])
def test_grid_real_obs_bitwise(da_win, dt):
    """da_win 3 with report times inside its slots: as in the reference, a
    report at dt >= 2.5 h goes to slot 3, which only a 6-slot window has."""
    hw = (32, 64)
    reps = [_reports(5, dt=dt)] + ([_reports(6, dt=dt)] if da_win > 3 else [])
    (yo_j, h_j), (yo_t, h_t) = (mod.grid_real_obs(reps, da_win, 40, hw) for mod in (jobs, tobs))
    np.testing.assert_array_equal(yo_t, yo_j)
    np.testing.assert_array_equal(h_t, h_j)
    assert yo_t.shape == (da_win, C_OBS, *hw) and h_t.sum() > 0
    for mod in (jobs, tobs):
        with pytest.raises(ValueError, match="40-level"):
            mod.grid_real_obs(reps, da_win, 20, hw)


def test_load_numpy_obs_bitwise(tmp_path):
    """Files in the layout of tests/test_da_engine.py (pandas' stem) read by
    the port's datetime stem, for two times and a too-short file."""
    rr = np.random.default_rng(8)
    for ts in ("2022-01-01 00:00", "2022-03-05 18:00"):
        t = pd.Timestamp(ts)
        d = tmp_path / str(t.year)
        d.mkdir(exist_ok=True)
        stem = str(t.to_datetime64())[:13]
        np.save(d / f"{stem}-obs.npy", rr.normal(size=(3, C_OBS, 8, 16)).astype(np.float32))
        np.save(d / f"{stem}-mask.npy", (rr.random((3, C_OBS, 8, 16)) < 0.1).astype(np.float64))
        for win in (1, 3):
            want = jobs.load_numpy_obs(str(tmp_path), t, win)
            got = tobs.load_numpy_obs(str(tmp_path), t.to_pydatetime(), win)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.float32
                np.testing.assert_array_equal(g, w)
        with pytest.raises(ValueError, match="need da_win=6"):
            tobs.load_numpy_obs(str(tmp_path), t.to_pydatetime(), 6)


def test_report_sources_equal_reference(tmp_path):
    """SyntheticReports equal to the reference's in one process (its noise
    seeds from hash(), which differs between processes), with noise and a
    spread of report times; LocalReportsStore reads a file and returns {}
    for a missing time."""
    hw = (24, 48)
    ts = pd.Timestamp("2022-01-01 06:00")
    for kw in ({}, {"noise": 0.5, "dt_range": (-3.0, 3.0)}):
        want = jreports.SyntheticReports(JaxEra5(hw=hw, seed=0), n_stations=60, seed=3,
                                         **kw).get_reports(ts)
        got = treports.SyntheticReports(TorchEra5(hw=hw, seed=0), n_stations=60, seed=3,
                                        **kw).get_reports(ts.to_pydatetime())
        assert got == want and len(got) == 60
    json.dump(want, open(tmp_path / "2022-01-01_06.json", "w"))
    for mod, t in ((jreports, ts), (treports, ts.to_pydatetime())):
        store = mod.LocalReportsStore(str(tmp_path))
        assert store.get_reports(t) == json.loads(json.dumps(want))
        assert store.get_reports(t + pd.Timedelta("6h")) == {}


@pytest.mark.parametrize("obs_type", ["real_simu", "real", "real_simuz", "real_simu_nofiltering",
                                      "real_simu_nofilteringz"])
def test_qc_filter_masks_equal(obs_type):
    """Gridded synthetic-station obs (with noise, so that QC rejects some)
    against the augmented truth, each package augmenting its own."""
    hw, win = (32, 64), 2
    src = JaxEra5(hw=hw, seed=1)
    reps = jreports.SyntheticReports(src, n_stations=500, seed=2, noise=30.0,
                                     dt_range=(-0.5, 1.5)).get_reports(pd.Timestamp("2022-01-01"))
    yo, H = jobs.grid_real_obs([reps], win, 40, hw)
    gt = np.stack([src.get_state(pd.Timestamp("2022-01-01") + pd.Timedelta(hours=t))
                   for t in range(win)])
    m = jinterp.obs_level_interp_matrix(40)
    std = jobs.std_layer_augmented(40)
    want = jobs.qc_filter(yo, np.asarray(jinterp.augment_levels(jnp.asarray(gt), m)), H, 0.1,
                          obs_type, std)
    gt_aug = tinterp.augment_levels(torch.from_numpy(gt), m)
    got = tobs.qc_filter(torch.from_numpy(yo), gt_aug, torch.from_numpy(H), 0.1, obs_type,
                         std).numpy()
    assert int((got != want).sum()) == 0
    kept, gridded = want.sum(), H.sum()
    assert 0 < kept <= gridded
    if obs_type in ("real_simu", "real"):
        assert kept < gridded  # the noise makes QC reject some


def test_mask_files_and_rules(tmp_path):
    """A mask_<obs_type>.npy file takes precedence over the column rule; a
    missing file falls back to it; prepbufr has no rule; an unknown type has
    neither."""
    hw = (16, 32)
    np.save(tmp_path / "mask_column_random_0100.npy",
            (np.random.default_rng(0).random((69, *hw)) < 0.2).astype(np.float64))
    for obs_type, mask_dir in (("column_random_0100", str(tmp_path)),
                               ("column_random_0200", str(tmp_path)),
                               ("column_random_0100", None)):
        want = jobs.make_obs_mask(obs_type, 2, hw, np.random.default_rng(3), mask_dir)
        got = tobs.make_obs_mask(obs_type, 2, hw, np.random.default_rng(3), mask_dir)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    from_file = tobs.make_obs_mask("column_random_0100", 1, hw, np.random.default_rng(3),
                                   str(tmp_path))
    np.testing.assert_array_equal(from_file[0], np.load(tmp_path / "mask_column_random_0100.npy"))
    with pytest.raises(ValueError, match="station reports"):
        tobs.make_obs_mask("prepbufr", 1, hw, np.random.default_rng(0))
    with pytest.raises(FileNotFoundError):
        tobs.make_obs_mask("mystery", 1, hw, np.random.default_rng(0), str(tmp_path))


def _real_bundle(da_win, seed=0):
    """(xb, yo, H, R) on the 204 augmented channels at FULL."""
    rr = np.random.default_rng(seed)
    m = jinterp.obs_level_interp_matrix(40)
    xb = _state(seed + 1, (69, *FULL))
    truth = _state(seed + 2, (da_win, 69, *FULL))
    aug = np.asarray(jinterp.augment_levels(jnp.asarray(truth), m))
    std = jobs.std_layer_augmented(40).reshape(1, -1, 1, 1)
    yo = (aug + 0.1 * std * rr.standard_normal(aug.shape)).astype(np.float32)
    H = (rr.random(aug.shape) < 0.05).astype(np.float32)
    R = jobs.build_R(jobs.obs_error_variance(0.005, 2), None, da_win, FULL)
    R_aug = np.asarray(jinterp.augment_levels(jnp.asarray(R), m))
    arrs = [np.array(a, np.float32) for a in (xb, yo, H, R_aug)]
    return (jcost.ObsBundle(*map(jnp.asarray, arrs)),
            tcost.ObsBundle(*map(torch.from_numpy, arrs)), m)


@pytest.fixture(scope="module")
def micro_models():
    jdec, pdec, tdec = model_pair(C.micro_vae_configs(img_size=LOW)[1], seed=1)
    jflow, pflow, tflow = model_pair(C.micro_config(img_size=LOW, attn_type="relbias"), seed=2)
    for mdl in (tdec, tflow):
        mdl.requires_grad_(False)
    return jdec, tdec, jflow, tflow, {"decoder": pdec, "flow": pflow}


@pytest.mark.parametrize("mode, da_win", [("vae4dvar", 1), ("vae4dvar", 3), ("sc4dvar", 1)])
def test_real_obs_full_cost_matches_jax(micro_models, mode, da_win):
    jdec, tdec, jflow, tflow, params = micro_models
    jb, tb, m = _real_bundle(da_win)
    flow_kw = dict(flow_hw=LOW, da_win=da_win, obs_coeff=0.8, interp_matrix=m)
    if mode == "vae4dvar":
        jc = jcost.make_vae4dvar_cost(jdec.apply, jflow.apply if da_win > 1 else None,
                                      **flow_kw)
        tc = tcost.make_vae4dvar_cost(tdec, tflow if da_win > 1 else None, **flow_kw)
        x = np.random.default_rng(11).standard_normal((1, 8, *LOW)).astype(np.float32) * 0.3
    else:
        from test_torch_sc4dvar import _pair

        jt, tt = _pair(jcvt.BMatrixAssets.synthetic(scale_factor=2.0), hw=LOW, out_hw=FULL,
                       hpad=28)
        jc = jcost.make_sc4dvar_cost(jt, **flow_kw)
        tc = tcost.make_sc4dvar_cost(tt, **flow_kw)
        x = np.random.default_rng(11).standard_normal((69, *LOW)).astype(np.float32) * 0.1
    (jcf, _, _), (tcf, _, tparts) = jc, tc
    want_j, want_g = jax.jit(jax.value_and_grad(lambda q: jcf(q, jb, params)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got_j = tcf(xt, tb)
    (got_g,) = torch.autograd.grad(got_j, xt)
    assert float(got_j.detach()) == pytest.approx(float(want_j), rel=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(to_np(got_g), want_g, rtol=0, atol=1e-5 * np.abs(want_g).max())
    jb_t, jo_t = (float(v) for v in tparts(xt.detach(), tb))
    assert jb_t == pytest.approx(0.5 * float((x.astype(np.float64) ** 2).sum()), rel=1e-6)
    assert jb_t + 0.8 * jo_t == pytest.approx(float(want_j), rel=1e-5)
