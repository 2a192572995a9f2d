"""The port's on-disk inputs against the JAX package's, and run_da on them.

- Stores: the port's LocalNpyStore and ReferenceLayoutStore (with the
  native loader pool and with np.load) read what the JAX package's stores
  read, bit for bit, from stores written in a tmp dir; the pool's
  epoch-tagged drain discards a stale delivery.
- run_da with checkpoints: the port's `run_da.main` with --micro, three
  checkpoints that scripts/orbax_to_torch.py converted from JAX-written
  orbax trees (the VAE as a full tree), no --fast_init and --data_dir in
  the reference layout gives the analysis, next background and metrics of
  the JAX package's `CycledDA` driven with the restored trees and the same
  store. rtol 1e-3 with a floor of 1e-5 x the channel std on fields and
  metrics that cross zero, as tests/test_torch_cycle.py (a forecast, the
  obs reduction and 2 x 10 L-BFGS iterations chained in f32).
- --data_dir against the synthetic source: a store holding
  `SyntheticEra5(seed)`'s frames gives the run without --data_dir, bit for
  bit, in run_da (both layouts) and in run_train_forecast (the losses).
- The branch of run_da.py:308: without a checkpoint and without
  --fast_init on a grid other than the solver grid, the advance is the flow
  model at the solver grid (run_da.py:323-328), no model runs at the
  analysis grid and the flash op is never called; the models carry
  flax-matched init (LayerNorm scales one). With --fast_init the forecast
  model advances at the analysis grid.
"""

import sys
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_util import flax_params
from vaevar_tpu import channels
from vaevar_tpu import config as C
from vaevar_tpu.da.cycler import CycledDA as JaxCycledDA
from vaevar_tpu.da.dynamics import make_integrate as jax_integrate
from vaevar_tpu.data import era5 as jera5
from vaevar_tpu.models.lgunet import LGUnet as JaxLGUnet
from vaevar_tpu.train import checkpoint as orbax_ckpt
from vaevar_tpu_torch import run_da, run_train_forecast
from vaevar_tpu_torch.da.cycler import CycledDA as TorchCycledDA
from vaevar_tpu_torch.data import era5 as tera5
from vaevar_tpu_torch.data import native_loader

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import orbax_to_torch  # noqa: E402

START, END = "2022-01-01 00:00:00", "2022-01-01 06:00:00"
T0 = datetime(2022, 1, 1)
METRICS = ("bg_wrmse", "ana_wrmse", "bg_mse", "ana_mse", "bg_bias", "ana_bias")


def _write_store(root, layout, hw, times, seed=0):
    src = tera5.SyntheticEra5(hw=hw, seed=seed)
    store = (tera5.ReferenceLayoutStore(root, hw, use_native=False) if layout == "reference"
             else tera5.LocalNpyStore(root, hw))
    for ts in times:
        store.save_state(ts, src.get_state(ts))
    return src


def test_port_builds_its_own_native_library():
    assert native_loader.available()
    assert native_loader.library_path().parent == REPO / "vaevar_tpu_torch" / "_build"
    assert native_loader.library_path().exists()


@pytest.mark.parametrize("layout", ["state", "reference"])
def test_store_reads_equal_jax(layout, tmp_path):
    hw = (17, 32)
    times = [T0, T0 + timedelta(hours=6)]
    src = _write_store(str(tmp_path), layout, hw, times)
    if layout == "state":
        ports = [tera5.LocalNpyStore(str(tmp_path), hw)]
        jaxes = [jera5.LocalNpyStore(str(tmp_path), hw)]
    else:
        ports = [tera5.ReferenceLayoutStore(str(tmp_path), hw, use_native=u) for u in (True, False)]
        jaxes = [jera5.ReferenceLayoutStore(str(tmp_path), hw, use_native=u) for u in (True, False)]
        assert [s.reader for s in ports] == ["native", "numpy"]
    for ts in times:
        want = src.get_state(ts)
        for store in ports + jaxes:
            got = store.get_state(ts)
            assert got.dtype == np.float32 and got.shape == (69, *hw)
            np.testing.assert_array_equal(got, want)
        assert all(s.has(ts) for s in ports)
    assert not ports[0].has(T0 + timedelta(hours=12))


def test_native_pool_drops_stale_deliveries_and_reports_missing_files(tmp_path):
    hw = (8, 16)
    src = _write_store(str(tmp_path), "reference", hw, [T0])
    store = tera5.ReferenceLayoutStore(str(tmp_path), hw)
    # what an aborted earlier call leaves in the pool: epoch-0 tags
    for i, p in enumerate(store._paths(T0)[:5]):
        store._pool.submit(p, tag=i)
    np.testing.assert_array_equal(store.get_state(T0), src.get_state(T0))
    np.testing.assert_array_equal(store.get_state(T0), src.get_state(T0))
    with pytest.raises(IOError, match="native loader failed"):
        store.get_state(T0 + timedelta(hours=6))


def _cycle_close(a, b, what, floor):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    excess = np.abs(a - b) - (1e-3 * np.abs(b) + floor)
    assert excess.max() <= 0, (what, a.flat[excess.argmax()], b.flat[excess.argmax()])


def test_run_da_with_orbax_checkpoints_matches_jax(tmp_path, monkeypatch):
    """Micro models at their converter presets' 16x32 grid, f32, free_0001
    obs, init_lag 1, Nit 2, zoom on both sides."""
    hw = (16, 32)
    enc_cfg, dec_cfg = C.micro_vae_configs()
    fc_cfg, flow_cfg = C.micro_config(), C.micro_config(attn_type="relbias")
    trees = {"vae": {"params": {"enc": flax_params(enc_cfg, 1)["params"],
                                "dec": flax_params(dec_cfg, 2)["params"]}},
             "flow": flax_params(flow_cfg, 3)["params"],
             "forecast": flax_params(fc_cfg, 4)}
    ckpts = {}
    for kind, tree in trees.items():
        orbax_ckpt.save(str(tmp_path / f"{kind}_orbax"), tree)
        ckpts[kind] = str(tmp_path / f"{kind}.pt")
        orbax_to_torch.main([kind, str(tmp_path / f"{kind}_orbax"), ckpts[kind], "--micro"])
    data = str(tmp_path / "era5")
    _write_store(data, "reference", hw, [T0 - timedelta(hours=6), T0])

    xa = {}
    real = TorchCycledDA.one_step_da
    monkeypatch.setattr(TorchCycledDA, "one_step_da",
                        lambda self, *a: xa.setdefault("port", real(self, *a)))
    da = run_da.main(["--device", "cpu", "--micro", "--no-bf16", "--grid", "16x32",
                      "--solver_grid", "16x32", "--init_lag", "1", "--Nit", "2",
                      "--obs_type", "free_0001", "--lbfgs_linesearch", "zoom",
                      "--end_time", END, "--work_dir", str(tmp_path / "port"),
                      "--vae_ckpt", ckpts["vae"], "--flow_ckpt", ckpts["flow"],
                      "--forecast_ckpt", ckpts["forecast"], "--data_dir", data,
                      "--data_layout", "reference"])
    assert da.state_source.reader == "native" and da.flow is None

    restored = {k: orbax_ckpt.restore(str(tmp_path / f"{k}_orbax")) for k in trees}
    from vaevar_tpu.train.checkpoint import vae_decoder_params

    jda = JaxCycledDA(
        C.DAConfig(nit=2, init_lag=1, obs_type="free_0001", lbfgs_linesearch="zoom",
                   latent_shape=(1, 8, *hw), grid_hw=hw, solver_hw=hw),
        jera5.ReferenceLayoutStore(data, hw), jax_integrate(JaxLGUnet(fc_cfg).apply),
        forecast_params=restored["forecast"], decoder_apply=JaxLGUnet(dec_cfg).apply,
        vae_params=vae_decoder_params(restored["vae"]), flow_params=restored["flow"],
        coeff_dir="dataset/bq_info_lr/", work_dir=str(tmp_path / "jax"), seed=0,
        verbose=False, prefetch_obs=False)
    jreal = jda.one_step_da
    jda.one_step_da = lambda *a: xa.setdefault("jax", jreal(*a))
    jda.run_assimilation(START, END)

    floor = 1e-5 * channels.STD
    _cycle_close(xa["port"].numpy(), np.asarray(xa["jax"]), "xa", floor.reshape(-1, 1, 1))
    (run,) = (tmp_path / "port").glob("run_*")
    _cycle_close(np.load(run / "xb.npy"), np.load(tmp_path / "jax" / "xb.npy"), "next xb",
                 floor.reshape(-1, 1, 1))
    for k in METRICS:
        _cycle_close(np.load(run / f"{k}.npy"), np.load(tmp_path / "jax" / f"{k}.npy"), k,
                     0.0 if k.endswith("mse") else floor)
    c = da.cycle_log[0]
    assert c["jb"][-1] > 0 and c["jb"][-1] + c["jo"][-1] < c["jb"][0] + c["jo"][0]


def _port_run(tmp_path, name, *extra):
    work = tmp_path / name
    run_da.main(["--device", "cpu", "--micro", "--fast_init", "--grid", "32x64",
                 "--solver_grid", "16x32", "--init_lag", "1", "--Nit", "1",
                 "--end_time", END, "--work_dir", str(work), *extra])
    (run,) = work.glob("run_*")
    return run


def test_run_da_data_dir_equals_synthetic(tmp_path):
    base = _port_run(tmp_path, "synthetic")
    for layout in ("state", "reference"):
        data = str(tmp_path / f"era5_{layout}")
        _write_store(data, layout, (32, 64), [T0 - timedelta(hours=6), T0])
        run = _port_run(tmp_path, layout, "--data_dir", data, "--data_layout", layout)
        for f in ("xb.npy", *(f"{k}.npy" for k in METRICS)):
            np.testing.assert_array_equal(np.load(run / f), np.load(base / f), err_msg=f)


def test_train_forecast_data_dir_equals_synthetic(tmp_path):
    # 30 h: validation takes the last 20 %, from 24 h, so every frame read
    # sits on the 6-hourly grid the store holds
    end = T0 + timedelta(hours=30)
    data = str(tmp_path / "era5")
    times = [T0 + timedelta(hours=6 * i) for i in range(6)]
    _write_store(data, "state", (32, 64), times)
    argv = ["--device", "cpu", "--micro", "--grid", "32x64", "--batch_size", "2",
            "--steps", "2", "--end_time", str(end), "--log_every", "1"]
    _, want = run_train_forecast.main(argv + ["--out_dir", str(tmp_path / "synthetic")])
    _, got = run_train_forecast.main(argv + ["--out_dir", str(tmp_path / "disk"),
                                             "--data_dir", data])
    assert len(got) == 2 and got == want


@pytest.mark.parametrize("init, advance", [([], "flow"), (["--fast_init"], "forecast")])
def test_run_da_branch_without_checkpoints(init, advance, tmp_path, monkeypatch):
    from vaevar_tpu_torch.models.lgunet import LGUnet
    from vaevar_tpu_torch.ops import attention

    calls, flash = [], []
    real_forward, real_flash = LGUnet.forward, attention.flash_attention
    monkeypatch.setattr(LGUnet, "forward", lambda self, x: calls.append(
        (self.cfg.attn_type, tuple(x.shape[-2:]))) or real_forward(self, x))
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v: flash.append(q.shape) or real_flash(q, k, v))
    da = run_da.main(["--device", "cpu", "--micro", "--grid", "32x64", "--solver_grid",
                      "16x32", "--init_lag", "2", "--Nit", "1", "--end_time", END,
                      "--work_dir", str(tmp_path), *init])
    full = [c for c in calls if c[1] == (32, 64)]
    if advance == "flow":
        # no model at the analysis grid: the 2 spin-up steps and the advance
        # run the flow model (run_da.py's --micro flow config) at the solver
        # grid, beside the decoder's calls
        assert full == [] and flash == []
        assert len(calls) > 3 and set(calls) == {("rope", (16, 32)), ("relbias", (16, 32))}
        norm = da.decoder.net.layers[0].blocks[0].norm1.weight
        assert bool((norm == 1).all())  # flax-matched init, not --fast_init
    else:
        assert full == [("rope", (32, 64))] * 3
