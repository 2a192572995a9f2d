"""ERA5-like state sources: the on-disk stores and the synthetic generator.

Copies of vaevar_tpu/data/era5.py (numpy), kept in the port so that the port
runs without the JAX package (tests/test_torch_import.py holds them equal to
the reference, and tests/test_torch_data.py their reads, bit for bit):
- `LocalNpyStore`: one float32 (69, H, W) file per timestamp under a root
  directory (`%Y-%m-%d_%H.npy`);
- `ReferenceLayoutStore`: the reference's per-variable-per-level archive
  layout, the 69 files of a frame read through the native C++ loader pool
  when it builds (its `reader` says which reader is in use);
- `SyntheticEra5`: deterministic, time-coherent band-limited fields advected
  zonally at channel-dependent speeds, in physical units through the
  channel mean/std registry; the same seed gives the reference's states;
- `SharedModeEra5`: the OSSE's truth, 69 channels loading on a few shared
  advecting modes, with its imperfect model (a roll at the mode-0 speed) as
  the cycler's forecast integrate, the NMC trainer's one-step model and the
  window's hourly flow, all `torch.roll` on the tensor's own device.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np
import torch

from vaevar_tpu_torch import channels

_FMT = "%Y-%m-%d_%H"


def _stamp(ts) -> str:
    if hasattr(ts, "strftime"):
        return ts.strftime(_FMT)
    return str(ts)


class LocalNpyStore:
    def __init__(self, root: str, hw=(721, 1440)):
        self.root = root
        self.hw = hw

    def path(self, ts) -> str:
        return os.path.join(self.root, _stamp(ts) + ".npy")

    def get_state(self, ts) -> np.ndarray:
        return np.load(self.path(ts)).astype(np.float32)

    def save_state(self, ts, state: np.ndarray):
        os.makedirs(self.root, exist_ok=True)
        np.save(self.path(ts), state.astype(np.float32))

    def has(self, ts) -> bool:
        return os.path.exists(self.path(ts))


class ReferenceLayoutStore:
    """Reads the reference's per-variable-per-level archive layout from a
    local root — the exact URL scheme of the petrel loader
    (dataset/dataset.py:429-434, init_file_list :185-190):

        multi-level : <root>/<year>/<date>/<time>-<vname>-<level>.0.npy
        single-level: <root>/single/<year>/<date>/<time>-<vname>.npy

    so an archive mirrored from the reference's S3 buckets works
    unchanged. Frames composite to the canonical (69, H, W) channel order
    (channels.CHANNEL_NAMES) in PHYSICAL units; the 69 per-frame file
    reads fan out over the native C++ loader pool when it is available.
    """

    def __init__(self, root: str, hw=(721, 1440), use_native: bool = True):
        self.root = root
        self.hw = hw
        self._pool = None
        if use_native:
            try:
                from vaevar_tpu_torch.data import native_loader

                self._pool = native_loader.NativePrefetcher(
                    sample_shape=hw, capacity=16, n_threads=8
                )
            except (OSError, RuntimeError):  # no library: read with np.load
                self._pool = None
        #: "native" when reads go through the C++ pool, "numpy" after the
        #: fallback to np.load (the JAX class falls back without saying so)
        self.reader = "numpy" if self._pool is None else "native"

    def _stamp_parts(self, ts):
        date = ts.strftime("%Y-%m-%d")
        time = ts.strftime("%H:%M:%S")
        return str(ts.year), date, time

    def _paths(self, ts) -> list[str]:
        year, date, time = self._stamp_parts(ts)
        paths = [
            os.path.join(self.root, "single", year, date,
                         f"{time}-{v}.npy")
            for v in channels.SINGLE_LEVEL_VNAMES
        ]
        for v in channels.MULTI_LEVEL_VNAMES:
            for lev in channels.PRESSURE_LEVELS:
                paths.append(
                    os.path.join(self.root, year, date,
                                 f"{time}-{v}-{lev}.0.npy")
                )
        return paths

    def get_state(self, ts) -> np.ndarray:
        paths = self._paths(ts)
        n = len(paths)
        out = np.empty((n, *self.hw), np.float32)
        if self._pool is not None:
            # epoch-encoded tags: a previous call that errored mid-drain
            # may have left completed samples in the pool; stale-epoch
            # deliveries are discarded instead of corrupting this frame
            self._epoch = getattr(self, "_epoch", 0) + 1
            base = self._epoch * n
            for i, p in enumerate(paths):
                self._pool.submit(p, tag=base + i)
            from vaevar_tpu_torch.data.native_loader import LoaderSampleError

            filled = 0
            while filled < n:
                try:
                    got = self._pool.next_tagged()
                except LoaderSampleError as e:
                    if e.tag >= 0 and e.tag // n != self._epoch:
                        continue  # stale-epoch failure: not our frame
                    raise IOError(
                        f"native loader failed reading {ts} (tag {e.tag})"
                    ) from e
                if got is None:
                    raise IOError(f"native loader timed out on {ts}")
                arr, tag = got
                if tag // n != self._epoch:
                    continue  # stale sample from an aborted earlier call
                out[tag - base] = arr
                filled += 1
        else:
            for i, p in enumerate(paths):
                out[i] = np.load(p).astype(np.float32)
        return out

    def has(self, ts) -> bool:
        return all(os.path.exists(p) for p in self._paths(ts))

    def save_state(self, ts, state: np.ndarray):
        """Write a (69, H, W) physical state as the layout's 69 files."""
        for p, field in zip(self._paths(ts), state):
            os.makedirs(os.path.dirname(p), exist_ok=True)
            np.save(p, field.astype(np.float32))


def _smooth_noise(rng: np.random.Generator, hw, cutoff_frac=0.12) -> np.ndarray:
    """Band-limited unit-variance random field."""
    H, W = hw
    f = rng.normal(size=(H, W))
    F = np.fft.rfft2(f)
    ky = np.fft.fftfreq(H)[:, None]
    kx = np.fft.rfftfreq(W)[None, :]
    keep = (np.abs(ky) < cutoff_frac) & (kx < cutoff_frac)
    F = F * keep
    g = np.fft.irfft2(F, s=(H, W))
    return (g / (g.std() + 1e-12)).astype(np.float32)


class _Roll(torch.nn.Module):
    """Parameter-free model on normalized (B, C, H, W) fields: a zonal roll
    by `shift` pixels, on the input's own device."""

    def __init__(self, shift: int):
        super().__init__()
        self.shift = int(shift)

    def forward(self, x):
        return torch.roll(x, self.shift, dims=-1)


class SharedModeEra5:
    """Cross-channel-correlated synthetic truth for OSSE experiments.

    All 69 channels load on a few SHARED advecting spatial modes:

        state_c(t) = mean_c + std_c * sum_m load[m, c] * roll(P_m, v_m * t)

    Real background errors are strongly cross-correlated (the reference's
    CVT regression/EOF coefficients and the VAE prior both exist to
    exploit exactly that, da_4dvar.py:890-906 / :1185); `SyntheticEra5`'s
    channels are statistically independent, which makes its model-error
    distribution incompressible for a small-latent VAE. This source gives
    OSSE tests an error distribution a VAE can actually learn: a model
    that advects everything at the mode-0 speed has an error field of
    rank `n_modes - 1` across channels."""

    def __init__(self, hw=(32, 64), seed: int = 0, speeds=(2, 1),
                 cutoffs=(0.12, 0.06), amp: float = 1.0):
        # defaults validated for cycled-DA experiments: the mode-1
        # mismatch drifts 1 px/h relative to the model against ~16 px
        # features, so analysis gains PERSIST into the next background
        # (a fast-decorrelating world injects a saturation-sized fresh
        # error every cycle and no assimilation can beat a free run)
        self.hw = hw
        rng = np.random.default_rng(seed)
        C = channels.N_CHANNELS
        self.speeds = tuple(int(s) for s in speeds)
        self.patterns = np.stack(
            [_smooth_noise(rng, hw, c) for c in cutoffs[: len(speeds)]]
        )
        # mode 0 dominates (the "flow"); later modes are the model-error
        # carriers. Random signs keep channels +/- correlated.
        scales = [0.9] + [0.45] * (len(self.speeds) - 1)
        self.load = np.stack([
            s * rng.uniform(0.6, 1.0, size=C)
            * rng.choice([-1.0, 1.0], size=C)
            for s in scales
        ]).astype(np.float32)  # (n_modes, C)
        self.amp = amp

    def _to_hours(self, ts) -> int:
        if hasattr(ts, "to_pydatetime") or isinstance(ts, datetime) \
                or hasattr(ts, "timestamp"):
            epoch = datetime(2000, 1, 1)
            t = ts.to_pydatetime() if hasattr(ts, "to_pydatetime") else ts
            if t.tzinfo is not None:
                t = t.replace(tzinfo=None)
            return int((t - epoch).total_seconds() // 3600)
        return int(ts)

    def get_state(self, ts) -> np.ndarray:
        h = self._to_hours(ts)
        f = np.zeros((channels.N_CHANNELS, *self.hw), np.float32)
        for m, v in enumerate(self.speeds):
            rolled = np.roll(self.patterns[m], h * v, axis=1)
            f += self.load[m][:, None, None] * rolled[None]
        return (
            channels.MEAN.reshape(-1, 1, 1)
            + self.amp * channels.STD.reshape(-1, 1, 1) * f
        ).astype(np.float32)

    def advect_model(self):
        """The OSSE's imperfect forecast model: advances 6 h by rolling the
        normalized anomaly at the MODE-0 speed (exact for mode 0, wrong for
        every other mode). Returns (integrate, fengwu):
        `integrate(x, steps, interpolation=False)` on physical (69, H, W)
        fields, the cycler's `forecast_integrate`, and `fengwu`, the
        matching normalized one-step model (B, C, H, W) -> (B, C, H, W) of
        the NMC trainer (train/vae_trainer.nmc_error_sample)."""
        shift6 = 6 * self.speeds[0]

        def integrate(x, steps, interpolation=False):
            del interpolation
            mean = torch.as_tensor(channels.MEAN, dtype=torch.float32,
                                   device=x.device).reshape(-1, 1, 1)
            return torch.roll(x - mean, steps * shift6, dims=-1) + mean

        return integrate, _Roll(shift6)

    def hourly_apply(self):
        """Normalized-space 1-HOUR step of the same imperfect model, the
        4D-Var window's flow model (cycler STEP cadence, reference hourly
        rollout da_4dvar.py:1190-1194), as a parameter-free module. Like
        `advect_model`, it advects at the mode-0 speed only, so window slots
        accumulate the same mode-1 model error the NMC-trained VAE learns."""
        return _Roll(self.speeds[0])


class SyntheticEra5:
    """state(t) = mean + std*(a*roll(base, v_c*t) + b*roll(mode2, u_c*t))."""

    def __init__(self, hw=(128, 256), seed: int = 0, amp: float = 1.0):
        self.hw = hw
        rng = np.random.default_rng(seed)
        C = channels.N_CHANNELS
        self.base = np.stack([_smooth_noise(rng, hw) for _ in range(C)])
        self.mode2 = np.stack([_smooth_noise(rng, hw, 0.06) for _ in range(C)])
        self.speed1 = rng.integers(1, 4, size=C)  # pixels per hour eastward
        self.speed2 = rng.integers(-2, 3, size=C)
        self.amp = amp

    @staticmethod
    def _hours(ts) -> int:
        if isinstance(ts, datetime):
            t = ts.replace(tzinfo=None)
            return int((t - datetime(2000, 1, 1)).total_seconds() // 3600)
        return int(ts)

    def get_state(self, ts) -> np.ndarray:
        h = self._hours(ts)
        C = channels.N_CHANNELS
        out = np.empty((C, *self.hw), np.float32)
        for c in range(C):
            f = 0.8 * np.roll(self.base[c], h * int(self.speed1[c]), axis=1)
            f += 0.35 * np.roll(self.mode2[c], h * int(self.speed2[c]), axis=1)
            out[c] = f
        return (
            channels.MEAN.reshape(-1, 1, 1)
            + self.amp * channels.STD.reshape(-1, 1, 1) * out
        ).astype(np.float32)
