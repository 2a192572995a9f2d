"""The port's OSSE pieces against the JAX package, and the OSSE itself.

Fast part (Tier-1):
- `SharedModeEra5`: states at several stamps, `patterns`, `load` and
  `speeds` bitwise (the same numpy code and draws); its imperfect model
  (`advect_model`'s integrate and one-step model, `hourly_apply`) bitwise
  against JAX's rolls (a roll moves values, and the f32 anomaly arithmetic
  is the same two operations).
- `nmc_error_sample` with a non-default `err_std`: rtol 1e-4, atol 1e-6
  (f32 forwards of the rolled-out micro model, tests/test_torch_vae_train.py's
  tolerance).
- The three vae4dvar costs with a non-default `err_std` (the reduced 3D-Var
  cost, the reduced window cost at da_win 3 with the OSSE's hourly roll
  inside J, and the full-grid cost): J rtol 1e-5, dJ/dz atol 1e-5 x its
  largest entry (f32 sums in another order, as tests/test_torch_window.py).
  `err_std=None` is the ERR_STD table, bit for bit.
- One micro vae4dvar cycle of the OSSE world with `err_std` against JAX's
  CycledDA, with tests/test_torch_cycle.py's tolerances (rtol 1e-3 with a
  floor of 1e-5 x the channel std on fields: the cycle chains the
  reduction and 2 x 4 L-BFGS iterations).

Science part (slow, like tests/test_osse_science.py): the port's OSSE at
32x64 (vaevar_tpu_torch/osse.py: the VAE trained 120 epochs on the world's
NMC errors, 2 days of free_run, vae4dvar, sc4dvar and the da_win 3 window)
under the JAX test's assertions and bounds, unchanged.
"""

from datetime import datetime, timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import model_pair, rand, to_np
from vaevar_tpu import channels
from vaevar_tpu import config as C
from vaevar_tpu.da import cost as jcost
from vaevar_tpu.da.cycler import CycledDA as JaxCycledDA
from vaevar_tpu.data.era5 import SharedModeEra5 as JaxShared
from vaevar_tpu.train import vae_trainer as jvt
from vaevar_tpu_torch import osse
from vaevar_tpu_torch.config import DAConfig as TorchDAConfig
from vaevar_tpu_torch.da import cost as tcost
from vaevar_tpu_torch.da import lbfgs as tlbfgs
from vaevar_tpu_torch.da.cycler import CycledDA as TorchCycledDA
from vaevar_tpu_torch.data.era5 import SharedModeEra5 as TorchShared
from vaevar_tpu_torch.train import vae_trainer as tvt

torch.set_num_threads(1)
HW = (32, 64)
RTOL = 1e-5
STAMPS = [datetime(2022, 1, 1), datetime(2021, 3, 1, 7), datetime(1999, 12, 31, 18), 5, -13]


def _err_std(seed=4):
    """A per-channel error std other than ERR_STD (the OSSE's is empirical)."""
    rng = np.random.default_rng(seed)
    return (channels.ERR_STD * rng.uniform(0.2, 3.0, 69)).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(seed=11), dict(hw=(16, 32), seed=3, speeds=(3, -1, 2),
                                                     cutoffs=(0.2, 0.1, 0.05), amp=0.5)])
def test_shared_mode_source_bitwise(kw):
    t, j = TorchShared(**kw), JaxShared(**kw)
    assert t.speeds == j.speeds and t.hw == j.hw and t.amp == j.amp
    np.testing.assert_array_equal(t.patterns, j.patterns)
    np.testing.assert_array_equal(t.load, j.load)
    for ts in STAMPS:
        got = t.get_state(ts)
        assert got.dtype == np.float32 and got.shape == (69, *t.hw)
        np.testing.assert_array_equal(got, j.get_state(ts), err_msg=str(ts))


def test_advect_and_hourly_models_bitwise():
    t, j = TorchShared(seed=11), JaxShared(seed=11)
    t_int, t_fengwu = t.advect_model()
    j_int, j_fengwu = j.advect_model()
    x = t.get_state(datetime(2022, 1, 1))
    for steps in (0, 1, 3):
        np.testing.assert_array_equal(t_int(torch.from_numpy(x), steps).numpy(),
                                      np.asarray(j_int(None, jnp.asarray(x), steps)))
    xn = rand((2, 69, *HW), 1)
    np.testing.assert_array_equal(t_fengwu(torch.from_numpy(xn)).numpy(),
                                  np.asarray(j_fengwu(None, jnp.asarray(xn))))
    np.testing.assert_array_equal(t.hourly_apply()(torch.from_numpy(xn)).numpy(),
                                  np.asarray(j.hourly_apply()(None, jnp.asarray(xn))))
    assert not list(t_fengwu.parameters()) and not list(t.hourly_apply().parameters())


@pytest.fixture(scope="module")
def models():
    dec = model_pair(C.micro_vae_configs(img_size=HW)[1], seed=1)
    flow = model_pair(C.micro_config(img_size=(16, 32), attn_type="relbias"), seed=2)
    for m in (dec[2], flow[2]):
        m.requires_grad_(False)
    return dec, flow


def test_nmc_error_sample_err_std_matches_jax(models):
    _, (jflow, jflow_p, tflow) = models
    frames = rand((2, 3, 69, 16, 32), 3)
    err_std = _err_std()
    want = np.asarray(jax.jit(lambda f: jvt.nmc_error_sample(
        f, jflow.apply, jflow_p, (8, 16), nmc_steps=2, err_std=err_std))(jnp.asarray(frames)))
    got = tvt.nmc_error_sample(torch.from_numpy(frames), tflow, (8, 16), nmc_steps=2,
                               err_std=err_std)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    default = tvt.nmc_error_sample(torch.from_numpy(frames), tflow, (8, 16), nmc_steps=2)
    assert not np.allclose(default.numpy(), got.numpy())


def _bundle(da_win, full=(47, 93), seed=0):
    rr = np.random.default_rng(seed)
    m, s = channels.MEAN.reshape(-1, 1, 1), channels.STD.reshape(-1, 1, 1)
    xb = (m + s * rr.normal(size=(69, *full))).astype(np.float32)
    yo = (m[None] + s[None] * rr.normal(size=(da_win, 69, *full))).astype(np.float32)
    H = (rr.random((da_win, 69, *full)) < 0.3).astype(np.float32)
    R = (s[None] ** 2 * (0.5 + rr.random((da_win, 69, *full)))).astype(np.float32)
    return xb, yo, H, R


@pytest.mark.parametrize("form", ["reduced", "window_reduced", "full"])
def test_vae4dvar_costs_with_err_std_match_jax(models, form):
    """J and dJ/dz with a non-default err_std; the window runs the OSSE's
    hourly roll inside J."""
    (jdec, jdec_p, tdec), _ = models
    err_std = _err_std()
    da_win = 1 if form == "reduced" else 3
    arrs = _bundle(da_win)
    jb = jcost.ObsBundle(*map(jnp.asarray, arrs))
    tb = tcost.ObsBundle(*map(torch.from_numpy, arrs))
    roll = TorchShared(seed=11)
    jflow = JaxShared(seed=11).hourly_apply()
    if form == "reduced":
        jb, tb = jcost.reduce_obs(jb, HW), tcost.reduce_obs(tb, HW)
        jc = jcost.make_vae4dvar_cost_reduced(jdec.apply, obs_coeff=1.3, err_std=err_std)[0]
        tcs = [tcost.make_vae4dvar_cost_reduced(tdec, obs_coeff=1.3, err_std=e)[0]
               for e in (err_std, None, channels.ERR_STD)]
    elif form == "window_reduced":
        jb, tb = jcost.reduce_obs_window(jb, HW), tcost.reduce_obs_window(tb, HW)
        jc = jcost.make_vae4dvar_cost_window_reduced(jdec.apply, jflow, da_win=da_win,
                                                     obs_coeff=1.3, err_std=err_std)[0]
        tcs = [tcost.make_vae4dvar_cost_window_reduced(tdec, roll.hourly_apply(), da_win=da_win,
                                                       obs_coeff=1.3, err_std=e)[0]
               for e in (err_std, None, channels.ERR_STD)]
    else:
        jc = jcost.make_vae4dvar_cost(jdec.apply, jflow, flow_hw=HW, da_win=da_win,
                                      obs_coeff=1.3, err_std=err_std)[0]
        tcs = [tcost.make_vae4dvar_cost(tdec, roll.hourly_apply(), flow_hw=HW, da_win=da_win,
                                        obs_coeff=1.3, err_std=e)[0]
               for e in (err_std, None, channels.ERR_STD)]
    z = rand((1, 8, *HW), 11, 0.5)
    params = {"decoder": jdec_p, "flow": None}
    vj, gj = jax.jit(jax.value_and_grad(lambda q, b: jc(q, b, params)))(jnp.asarray(z), jb)
    (vt, gt), (vn, gn), (ve, ge) = (
        tlbfgs.value_and_grad(lambda q: c(q, tb), torch.from_numpy(z)) for c in tcs)
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
    gj = np.asarray(gj)
    np.testing.assert_allclose(to_np(gt), gj, rtol=RTOL, atol=RTOL * np.abs(gj).max())
    # None is the reference's stdTr table, bit for bit, and differs from err_std
    assert float(vn) == float(ve) and torch.equal(gn, ge)
    g_obs = gt - torch.from_numpy(z)  # dJo/dz: dJb/dz is z
    assert torch.linalg.vector_norm(gn - gt) > 0.1 * torch.linalg.vector_norm(g_obs)


def test_cycle_with_err_std_matches_jax(models, tmp_path):
    """One 3D-Var vae4dvar cycle of the OSSE world (its truth, its roll as
    the forecast model) with the decoder scaled by err_std, against JAX."""
    (jdec, jdec_p, tdec), _ = models
    err_std = _err_std(5)
    kw = dict(da_mode="vae4dvar", nit=2, lbfgs_iters=4, init_lag=1, obs_type="column_random_2000",
              obs_std=0.1, grid_hw=HW, solver_hw=HW, latent_shape=(1, 8, *HW))
    start, end = "2022-01-01 00:00:00", "2022-01-01 06:00:00"
    jsrc, tsrc = JaxShared(hw=HW, seed=11), TorchShared(hw=HW, seed=11)
    jda = JaxCycledDA(C.DAConfig(lbfgs_linesearch="zoom", **kw), jsrc, jsrc.advect_model()[0],
                      decoder_apply=jdec.apply, vae_params=jdec_p, err_std=err_std,
                      work_dir=str(tmp_path / "jax"), seed=1, verbose=False,
                      prefetch_obs=False)
    tda = TorchCycledDA(TorchDAConfig(lbfgs_linesearch="zoom", **kw), tsrc,
                        tsrc.advect_model()[0], tdec, err_std=err_std,
                        work_dir=str(tmp_path / "port"), seed=1, verbose=False, device="cpu")
    xj = np.asarray(jax.device_get(jda.run_assimilation(start, end)))
    xt = tda.run_assimilation(start, end).numpy()
    floor = 1e-5 * channels.STD

    def close(a, b, what, fl=0.0):
        excess = np.abs(np.asarray(a) - np.asarray(b)) - (1e-3 * np.abs(np.asarray(b)) + fl)
        assert excess.max() <= 0, (what, excess.max())

    close(xt, xj, "next xb", floor.reshape(-1, 1, 1))
    for k in ("bg_wrmse", "ana_wrmse", "bg_bias", "ana_bias"):
        close(np.load(tmp_path / "port" / f"{k}.npy"), np.load(tmp_path / "jax" / f"{k}.npy"),
              k, floor)
    for k in ("bg_mse", "ana_mse"):
        close(np.load(tmp_path / "port" / f"{k}.npy"), np.load(tmp_path / "jax" / f"{k}.npy"), k)
    ana, bg = np.load(tmp_path / "port" / "ana_wrmse.npy"), np.load(tmp_path / "port" /
                                                                    "bg_wrmse.npy")
    assert not np.array_equal(ana, bg)  # the solve moved the state


def _jax_osse_vae_init(seed=0):
    """The JAX OSSE's initial VAE (tests/test_osse_science.py: train_vae's
    init at `seed`, the flax init of PRNGKey(seed)), as the port's
    state_dict."""
    from vaevar_tpu.models.vae import VAE as JaxVAE
    from vaevar_tpu_torch.utils.port_jax import vae_state_dict_from_flax

    enc, dec = C.micro_vae_configs(img_size=HW)
    err = jnp.zeros((8, 69, *HW), jnp.float32)
    params = JaxVAE(enc, dec).init(jax.random.PRNGKey(seed), err, jax.random.PRNGKey(0))
    return vae_state_dict_from_flax(jax.tree.map(np.asarray, params), enc, dec)


def test_osse_vae_init_is_jax_init():
    """vaevar_tpu_torch/osse_vae_init.npz holds the JAX OSSE's initial VAE
    bit for bit (written by `python tests/test_torch_osse.py`), so the port's
    OSSE starts where JAX's does; osse.build_world loads it."""
    want = _jax_osse_vae_init()
    got = np.load(osse.INIT_PATH)
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_osse_training_repeats_and_deterministic_restores():
    """osse.build_world trains under torch's deterministic algorithms, so
    two trainings (1 epoch, the default draw and another seed) repeat bit
    for bit, another seed gives another VAE, and `deterministic` gives the
    caller's settings back."""
    torch.use_deterministic_algorithms(False)
    with osse.deterministic():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cudnn.allow_tf32
    assert not torch.are_deterministic_algorithms_enabled()
    runs = [osse.build_world("cpu", epochs=1, seed=s) for s in (0, 0, 3)]
    a, b, c = ([p.detach().numpy() for p in w.decoder.parameters()] for w in runs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert runs[0].history == runs[1].history != runs[2].history
    assert not all(np.array_equal(x, z) for x, z in zip(a, c))


# --- science part (slow) -----------------------------------------------------


@pytest.fixture(scope="module")
def osse_world():
    world = osse.build_world("cpu")
    # training must have actually learned the error distribution (the
    # zero-predictor SSE level is ~2 * 8*69*32*64 with sigma=0.5)
    assert world.history[-1]["loss"] < 0.35 * world.history[0]["loss"], (
        world.history[0]["loss"], world.history[-1]["loss"])
    return world


@pytest.fixture(scope="module")
def cycled(osse_world, tmp_path_factory):
    out = osse.run_cycles(osse_world, str(tmp_path_factory.mktemp("osse")), device="cpu")
    return {k: v[:2] for k, v in out.items()}


@pytest.mark.slow
class TestOsseScience:
    """tests/test_osse_science.py's assertions and bounds on the port."""

    def test_vae4dvar_analysis_beats_background(self, cycled):
        bg, ana = cycled["vae4dvar"]
        for ci in (osse.Z500, osse.T850, osse.T2M):
            assert (ana[:, ci] < bg[:, ci]).all(), ci
            ratio = ana[:, ci].mean() / bg[:, ci].mean()
            assert ratio < 0.85, (ci, ratio)

    def test_vae4dvar_cycled_beats_free_run(self, cycled):
        bg, _ = cycled["vae4dvar"]
        fr, _ = cycled["free_run"]
        for ci in (osse.Z500, osse.T850, osse.T2M):
            ratio = bg[1:, ci].mean() / fr[1:, ci].mean()
            assert ratio < 0.85, (ci, ratio)

    def test_sc4dvar_analysis_beats_background_every_cycle(self, cycled):
        bg, ana = cycled["sc4dvar"]
        for ci in (osse.Z500, osse.T850, osse.T2M):
            assert (ana[:, ci] < bg[:, ci]).mean() >= 0.85, ci
            assert ana[:, ci].mean() / bg[:, ci].mean() < 0.95, ci

    def test_sc4dvar_cycled_beats_free_run(self, cycled):
        bg, _ = cycled["sc4dvar"]
        fr, _ = cycled["free_run"]
        for ci in (osse.Z500, osse.T850, osse.T2M):
            ratio = bg[1:, ci].mean() / fr[1:, ci].mean()
            assert ratio < 0.9, (ci, ratio)

    def test_free_run_control_does_nothing(self, cycled):
        bg, ana = cycled["free_run"]
        np.testing.assert_array_equal(bg, ana)

    def test_vae4dvar_window_analysis_beats_background(self, cycled):
        bg, ana = cycled["vae4dvar_win"]
        for ci in (osse.Z500, osse.T850, osse.T2M):
            assert (ana[:, ci] < bg[:, ci]).all(), ci
            ratio = ana[:, ci].mean() / bg[:, ci].mean()
            assert ratio < 0.85, (ci, ratio)

    def test_vae4dvar_window_cycled_beats_free_run(self, cycled):
        bg, _ = cycled["vae4dvar_win"]
        fr, _ = cycled["free_run"]
        for ci in (osse.Z500, osse.T850, osse.T2M):
            ratio = bg[1:, ci].mean() / fr[1:, ci].mean()
            assert ratio < 0.85, (ci, ratio)

    def test_check_reports_every_bound(self, cycled):
        """osse.check, which chip_smoke.py's osse phase gates on, passes
        here and covers every assertion above (3 channels x 3 modes x 3)."""
        rows = osse.check({k: (*v, 0.0) for k, v in cycled.items()})
        assert len(rows) == 27 and not osse.missed(rows)


# --- the seed sweep -------------------------------------------------------------


def _jax_osse(seed, root, port_cycles=False):
    """tests/test_osse_science.py's world and 4 runs with train_vae's `seed`
    (its initial weights and noise), in the JAX package; with `port_cycles`
    the port cycles the JAX-trained VAE."""
    import pandas as pd

    import test_osse_science as jt
    from vaevar_tpu.models.vae import VAE as JaxVAE

    src = JaxShared(hw=HW, seed=11)
    integrate, fengwu_apply = src.advect_model()
    t0 = pd.Timestamp("2021-01-01 00:00")
    starts = [t0 + i * pd.Timedelta("6h") for i in range(48)]
    frames = np.stack([np.stack([(src.get_state(t + k * pd.Timedelta("6h")) - jt.MEAN3) / jt.STD3
                                 for k in range(5)]) for t in starts]).astype(np.float32)
    err_std = np.maximum((frames[:, 4] - np.roll(frames[:, 0], 24 * src.speeds[0], -1))
                         .std(axis=(0, 2, 3)), 1e-3).astype(np.float32)
    err6_std = np.maximum((frames[:, 1] - np.roll(frames[:, 0], 6 * src.speeds[0], -1))
                          .std(axis=(0, 2, 3)), 1e-3).astype(np.float32)
    enc, dec = C.micro_vae_configs(img_size=HW)
    vae = JaxVAE(enc, dec)

    def factory(epoch):
        idx = np.random.default_rng(100 + epoch).permutation(len(starts))
        for i in range(0, len(idx), 8):
            yield frames[idx[i:i + 8]]

    params, hist = jvt.train_vae(vae, fengwu_apply, None, factory, epochs=120, latent_hw=HW,
                                 sigma=0.5, lr=1e-3, seed=seed, log_every=10 ** 9,
                                 sample_at_epoch_end=False, err_std=err_std)
    if port_cycles:  # the JAX-trained VAE, cycled by the port
        from vaevar_tpu_torch import config as tcfg
        from vaevar_tpu_torch.models.vae import VAE
        from vaevar_tpu_torch.utils.port_jax import vae_state_dict_from_flax

        tvae = VAE(*tcfg.micro_vae_configs(img_size=HW))
        tvae.load_state_dict(vae_state_dict_from_flax(jax.tree.map(np.asarray, params), enc,
                                                      dec), strict=True)
        world = osse.build_world("cpu", epochs=0)
        world.decoder = tvae.dec.eval().requires_grad_(False)
        return {k: v[:2] for k, v in osse.run_cycles(world, str(root), "cpu").items()}, hist
    dec_apply = lambda p, z: vae.apply(p, z, method=JaxVAE.decoder)
    world = (src, integrate, dec_apply, params, err_std, err6_std)
    cycled = {m: jt._cycle(world, m, root / m) for m in ("free_run", "vae4dvar", "sc4dvar")}
    cycled["vae4dvar_win"] = jt._cycle(world, "vae4dvar", root / "vae4dvar_win", da_win=3)
    return cycled, hist


def _port_osse(seed, init, root):
    world = osse.build_world("cpu", seed=seed, init=init)
    return {k: v[:2] for k, v in osse.run_cycles(world, str(root), "cpu").items()}, world.history


def _rejection_trunc_normal(t, std, generator):
    """N(0, std^2) truncated at +-2 std by rejection on torch.randn: the
    distribution of nn.init.trunc_normal_, another draw."""
    a = torch.randn(t.shape, generator=generator)
    out = a.abs() > 2.0
    while bool(out.any()):
        a[out] = torch.randn(int(out.sum()), generator=generator)
        out = a.abs() > 2.0
    t.copy_(a * std)


def sweep(arm, seed, out):
    """One OSSE of the seed sweep, on the CPU, written to `out` as JSON: the
    27 rows of osse.ratios, the missed ones, the loss of every step.
    Arms: `jax` (the JAX package at train_vae seed `seed`);
    `jax_trained_port_cycled` (JAX's trained VAE in the port's cycles); `port_jax_init`
    (the port from JAX's initial weights of `seed`); `port` (the port's
    own init_like_flax draw of `seed`, nn.init.trunc_normal_); `port_rejection`
    (the same with truncation by rejection). Every arm draws JAX's noise of
    `seed`. Run: `python tests/test_torch_osse.py sweep ARM SEED OUT.json`."""
    import json
    import tempfile
    from pathlib import Path

    from vaevar_tpu_torch import config as tcfg
    from vaevar_tpu_torch.models import init as tinit
    from vaevar_tpu_torch.models.vae import VAE

    def own_init():
        vae = VAE(*tcfg.micro_vae_configs(img_size=HW))
        return tinit.init_like_flax(vae, torch.Generator().manual_seed(seed)).state_dict()

    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        if arm in ("jax", "jax_trained_port_cycled"):
            cycled, hist = _jax_osse(seed, root, arm != "jax")
        elif arm == "port_jax_init":
            cycled, hist = _port_osse(seed, _jax_osse_vae_init(seed), root)
        elif arm == "port":
            cycled, hist = _port_osse(seed, own_init(), root)
        elif arm == "port_rejection":
            tinit._trunc_normal = _rejection_trunc_normal
            cycled, hist = _port_osse(seed, own_init(), root)
        else:
            raise ValueError(arm)
    rows = osse.ratios(cycled)
    with open(out, "w") as f:
        json.dump({"arm": arm, "seed": seed, "torch": torch.__version__, "rows": rows,
                   "missed": osse.missed(rows),
                   "loss": [float(h["loss"]) for h in hist]}, f)


def summary(paths):
    """Per arm of `sweep`'s JSON files: the seeds whose 27 bounds all held,
    and the worst vae4dvar or window ana/bg per seed with its median; then,
    for every seed with several runs, each run's largest ratio gap to the
    JAX run (or the first) and its relative loss gap at a few steps:
    `python tests/test_torch_osse.py summary OUT*.json`."""
    import json
    from collections import defaultdict

    runs = defaultdict(dict)
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        runs[d["arm"]][(d["seed"], p)] = d
    for arm, got in runs.items():
        worst = {k: max(v for n, v, _ in d["rows"] if "vae4dvar" in n and n.endswith("ana/bg"))
                 for k, d in got.items()}
        held = [k[0] for k, d in sorted(got.items()) if not d["missed"]]
        print(f"{arm}: all bounds held at {len(held)} of {len(got)} seeds {held}; worst "
              f"vae4dvar/window ana/bg median {np.median(list(worst.values())):.3f}: "
              + " ".join(f"{k[0]}:{v:.3f}" for k, v in sorted(worst.items())))
    by_seed = defaultdict(list)
    for arm, got in runs.items():
        for (seed, p), d in got.items():
            by_seed[seed].append((arm != "jax", p, d))
    steps = [0, 20, 50, 100, 200, 400, 719]
    for seed, ds in sorted(by_seed.items()):
        _, p0, d0 = min(ds, key=lambda t: t[:2])
        h0, r0 = np.asarray(d0["loss"], np.float64), [v for _, v, _ in d0["rows"]]
        for _, p, d in sorted(ds, key=lambda t: t[:2]):
            if p == p0:
                continue
            h = np.asarray(d["loss"], np.float64)
            gap = max(abs(v - w) for v, (_, w, _) in zip(r0, d["rows"]))
            print(f"seed {seed}: {p} vs {p0}: largest ratio gap {gap:.3g}" + (
                "; loss rel gap at steps " + ", ".join(
                    f"{i}: {abs(h[i] - h0[i]) / h0[i]:.2g}" for i in steps if i < len(h))
                if len(h) > 2 and len(h0) > 2 else ""))


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["sweep"]:
        sweep(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["summary"]:
        summary(sys.argv[2:])
    else:
        np.savez(osse.INIT_PATH, **{k: v.numpy() for k, v in _jax_osse_vae_init().items()})
