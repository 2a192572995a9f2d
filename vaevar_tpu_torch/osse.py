"""The cycled OSSE on the port: train the VAE on the world's own NMC errors,
then show that assimilation helps in truth space.

The port of tests/test_osse_science.py's world and cycles, so that the slow
test (tests/test_torch_osse.py) and the card's smoke (chip_smoke.py, phase
`osse`) run the same experiment:
- truth: `SharedModeEra5(hw=(32, 64), seed=11)`, 69 channels loading on two
  shared advecting modes; the imperfect forecast model advects everything at
  the mode-0 speed, so the background error is rank 1 across channels;
- the micro VAE (`micro_vae_configs`) trained 120 epochs (sigma 0.5, lr 1e-3,
  batch 8, no prior sample) on the 24 h NMC errors of 48 six-hourly starts,
  scaled by their empirical per-channel std, from the JAX test's initial
  weights (`osse_vae_init.npz`) with the JAX trainer's noise: which bounds
  hold depends on that random draw, in both packages (a JAX run with
  another seed misses them), so the port replays JAX's draw;
  `build_world(seed=, init=)` takes another draw, as the seed sweep of
  `python tests/test_torch_osse.py sweep` does;
- `column_random_2000` obs of the truth with obs_std 0.1, cycled for 2 days
  as free_run, vae4dvar (decoder scaled by the empirical 6 h error std),
  sc4dvar on the calibrated synthetic B, and vae4dvar with a da_win 3 window
  (the hourly roll as the flow model inside J).

`ratios` gives every quantity the JAX test asserts on, beside its bound;
`check` fails on any that is missed. The bounds are the JAX test's,
unchanged. The training and the cycles run with torch's deterministic
algorithms (`deterministic`), so the OSSE on a card repeats bit for bit
from run to run, as it does on the CPU, and its gate gives one answer.
`build_world`, `cycle` and `run_cycles` run on the card unless given
device="cpu"; without a card the default raises.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
from dataclasses import dataclass
from datetime import datetime, timedelta

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch import config as cfgs
from vaevar_tpu_torch.da.cvt import BMatrixAssets, CVTransform
from vaevar_tpu_torch.da.cycler import CycledDA, check_device
from vaevar_tpu_torch.data.era5 import SharedModeEra5
from vaevar_tpu_torch.models.vae import VAE
from vaevar_tpu_torch.train.vae_trainer import train_vae

HW = (32, 64)
# the JAX OSSE's initial VAE weights (its flax init at seed 0), as the port's
# state_dict; tests/test_torch_osse.py writes and checks the file
INIT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "osse_vae_init.npz")
Z500, T850, T2M = 11, 66, 2
CHANNELS = {"z500": Z500, "t850": T850, "t2m": T2M}
MODES = ("free_run", "vae4dvar", "sc4dvar", "vae4dvar_win")
# tests/test_osse_science.py's bounds per mode: the share of cycles whose
# analysis beats the background, mean ana/bg, and mean bg/free-run bg after
# cycle 0
BOUNDS = {"vae4dvar": (1.0, 0.85, 0.85), "vae4dvar_win": (1.0, 0.85, 0.85),
          "sc4dvar": (0.85, 0.95, 0.9)}
MEAN3 = channels.MEAN.reshape(-1, 1, 1)
STD3 = channels.STD.reshape(-1, 1, 1)


@dataclass
class World:
    src: SharedModeEra5
    integrate: object  # the imperfect forecast model on physical fields
    decoder: torch.nn.Module  # the trained VAE's decoder
    err_std: np.ndarray  # (69,) empirical 24 h NMC error std (training)
    err6_std: np.ndarray  # (69,) empirical 6 h error std (the cycler's scaling)
    history: list  # per-step training metrics
    train_s: float


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms inside the block (an op without one
    raises), with the cuBLAS workspace setting they need on a card, and f32
    products without TF32 (cuDNN allows it by default), so the result does
    not hang on the caller's settings; the previous settings come back
    after it."""
    was = torch.are_deterministic_algorithms_enabled()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def build_world(device="cuda", epochs: int = 120, seed: int = 0, init=None) -> World:
    """Truth source, imperfect model, the VAE TRAINED on the world's NMC
    errors, and the empirical error stds. The VAE starts from `init` (a VAE
    state_dict; by default the JAX OSSE's initial weights) and train_vae
    draws the JAX trainer's noise of `seed`, so by default the port trains
    the JAX OSSE's VAE up to round-off. Without a card, pass device="cpu"."""
    check_device(device)
    src = SharedModeEra5(hw=HW, seed=11)
    integrate, fengwu = src.advect_model()

    t0 = datetime(2021, 1, 1)
    starts = [t0 + i * timedelta(hours=6) for i in range(48)]

    def frames_for(ts):
        return np.stack([(src.get_state(ts + k * timedelta(hours=6)) - MEAN3) / STD3
                         for k in range(5)])

    frames = np.stack([frames_for(t) for t in starts]).astype(np.float32)
    pred24 = np.roll(frames[:, 0], 24 * src.speeds[0], axis=-1)
    err_std = np.maximum((frames[:, 4] - pred24).std(axis=(0, 2, 3)), 1e-3).astype(np.float32)
    pred6 = np.roll(frames[:, 0], 6 * src.speeds[0], axis=-1)
    err6_std = np.maximum((frames[:, 1] - pred6).std(axis=(0, 2, 3)), 1e-3).astype(np.float32)

    enc, dec = cfgs.micro_vae_configs(img_size=HW)
    vae = VAE(enc, dec)
    if init is None:
        with np.load(INIT_PATH) as f:
            init = {k: torch.from_numpy(f[k]) for k in f.files}
    vae.load_state_dict(init, strict=True)
    vae.to(device)
    B = 8

    def factory(epoch):
        rng = np.random.default_rng(100 + epoch)
        idx = rng.permutation(len(starts))
        for i in range(0, len(idx), B):
            yield frames[idx[i:i + B]]

    t = time.perf_counter()
    with deterministic():
        vae, hist = train_vae(vae, fengwu.to(device), factory, epochs=epochs, latent_hw=HW,
                              sigma=0.5, lr=1e-3, seed=seed, log_every=10 ** 9,
                              sample_at_epoch_end=False, err_std=err_std)
    train_s = time.perf_counter() - t
    decoder = vae.dec.eval().requires_grad_(False)
    return World(src, integrate, decoder, err_std, err6_std, hist, train_s)


def cycle(world: World, mode: str, work_dir: str, n_days: int = 2, da_win: int = 1,
          device="cuda"):
    """Cycle `mode` for `n_days` from 2022-01-01; returns (bg_wrmse,
    ana_wrmse) as (cycles, 69) arrays and the run's seconds."""
    check_device(device)
    cfg = cfgs.DAConfig(
        da_mode=mode, da_win=da_win, nit=3, lbfgs_iters=10,
        obs_type="column_random_2000", obs_std=0.1, modify_tp=2,
        grid_hw=HW, solver_hw=HW, latent_shape=(1, 8, *HW),
        init_tp=0, init_lag=1, save_interval=100,
    )
    shutil.rmtree(work_dir, ignore_errors=True)
    t = time.perf_counter()
    with deterministic():
        da = CycledDA(
            cfg, world.src, world.integrate, decoder=world.decoder,
            err_std=world.err6_std,
            flow=world.src.hourly_apply() if da_win > 1 else None,
            cvt=CVTransform(BMatrixAssets.synthetic(device=device), HW, HW, hpad=28,
                            device=device),
            work_dir=str(work_dir), verbose=False, seed=1, device=str(device),
        )
        da.run_assimilation(datetime(2022, 1, 1),
                            datetime(2022, 1, 1) + n_days * timedelta(days=1))
    return (np.asarray(da.metrics_list["bg_wrmse"]), np.asarray(da.metrics_list["ana_wrmse"]),
            time.perf_counter() - t)


def run_cycles(world: World, root: str, device="cuda") -> dict:
    """{mode: (bg, ana, seconds)} for the four runs of MODES."""
    check_device(device)
    out = {}
    for mode in MODES:
        base, da_win = ("vae4dvar", 3) if mode == "vae4dvar_win" else (mode, 1)
        out[mode] = cycle(world, base, os.path.join(root, mode), da_win=da_win, device=device)
    return out


def ratios(cycled: dict) -> list[tuple[str, float, float]]:
    """(name, value, bound) of every assertion of tests/test_osse_science.py:
    a value must lie strictly below its bound, except the 'share' rows of
    cycles where the analysis beats the background, which must reach it."""
    fr = cycled["free_run"][0]
    rows = []
    for name, ci in CHANNELS.items():
        for mode, (every, ab, fb) in BOUNDS.items():
            bg, ana = cycled[mode][0], cycled[mode][1]
            rows.append((f"{mode} {name} share of cycles ana < bg",
                         float((ana[:, ci] < bg[:, ci]).mean()), every))
            rows.append((f"{mode} {name} ana/bg", float(ana[:, ci].mean() / bg[:, ci].mean()),
                         ab))
            # skip cycle 0 (identical init); matched cycles afterwards
            rows.append((f"{mode} {name} bg/free-run bg",
                         float(bg[1:, ci].mean() / fr[1:, ci].mean()), fb))
    return rows


def missed(rows) -> list[tuple[str, float, float]]:
    """The rows of `ratios` whose bound is missed."""
    return [(n, v, b) for n, v, b in rows
            if (v < b if "share" in n else not v < b)]


def check(cycled: dict) -> list[tuple[str, float, float]]:
    """Every bound of the JAX OSSE test, raising on a miss; the free run
    must leave its analysis equal to its background. Returns `ratios`."""
    bg, ana = cycled["free_run"][:2]
    if not np.array_equal(bg, ana):
        raise AssertionError("free_run changed its background")
    rows = ratios(cycled)
    bad = missed(rows)
    if bad:
        raise AssertionError(f"OSSE bounds missed: {bad}")
    return rows
