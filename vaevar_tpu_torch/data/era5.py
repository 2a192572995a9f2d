"""Synthetic ERA5-like state source.

A copy of vaevar_tpu/data/era5.py::SyntheticEra5 (numpy), kept in the port so
that the port runs without the JAX package: deterministic, time-coherent
band-limited fields advected zonally at channel-dependent speeds, in
physical units through the channel mean/std registry. The same seed gives
the same states as the reference (tests/test_torch_import.py).
"""

from __future__ import annotations

from datetime import datetime

import numpy as np

from vaevar_tpu_torch import channels


def _smooth_noise(rng: np.random.Generator, hw, cutoff_frac=0.12) -> np.ndarray:
    """Band-limited unit-variance random field."""
    H, W = hw
    f = rng.normal(size=(H, W))
    F = np.fft.rfft2(f)
    ky = np.fft.fftfreq(H)[:, None]
    kx = np.fft.rfftfreq(W)[None, :]
    F = F * ((np.abs(ky) < cutoff_frac) & (kx < cutoff_frac))
    g = np.fft.irfft2(F, s=(H, W))
    return (g / (g.std() + 1e-12)).astype(np.float32)


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
