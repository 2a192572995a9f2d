"""Synthetic ERA5-like truth, made on the device from the seed.

The generator of vaevar_tpu_torch/data/era5.py::SyntheticEra5, moved to the
device: per channel c two band-limited unit-variance fields (`base` with
wavenumbers below 0.12 of the grid, `mode2` below 0.06) advected zonally by
whole pixels per hour,

    state_c(t) = mean_c + std_c (0.8 roll(base_c, v_c t) + 0.35 roll(mode2_c, u_c t)),

v_c in 1..3 and u_c in -2..2 pixels per hour, t in hours since 2000-01-01.
The fields come from one torch.Generator on the device (`torch.randn`, the
FFT filter), not from numpy's stream, so the states are this benchmark's
own, the same for the same seed. `get_state` returns a host numpy array, as
the cycler's state sources do; `state` keeps it on the device.
"""

from __future__ import annotations

from datetime import datetime

import numpy as np
import torch

from reference import channels


def _band_limited(g, n, hw, cutoff, device):
    H, W = hw
    f = torch.randn((n, H, W), generator=g, device=device)
    F = torch.fft.rfft2(f)
    del f
    ky = torch.fft.fftfreq(H, device=device).abs()[:, None]
    kx = torch.fft.rfftfreq(W, device=device)[None, :]
    F *= ((ky < cutoff) & (kx < cutoff)).to(F.dtype)
    out = torch.fft.irfft2(F, s=(H, W))
    del F
    return out / (out.std(dim=(1, 2), keepdim=True) + 1e-12)


class DeviceEra5:
    def __init__(self, hw, seed: int, device):
        self.hw, self.device = tuple(hw), torch.device(device)
        g = torch.Generator(device=self.device)
        g.manual_seed((int(seed) * 8 + 5) % (2 ** 63))
        C = channels.N_CHANNELS
        self.base = _band_limited(g, C, self.hw, 0.12, self.device)
        self.mode2 = _band_limited(g, C, self.hw, 0.06, self.device)
        speeds = torch.randint(0, 8, (2, C), generator=g, device=self.device).cpu().numpy()
        self.speed1 = 1 + speeds[0] % 3
        self.speed2 = speeds[1] % 5 - 2
        self.mean = torch.as_tensor(channels.MEAN, dtype=torch.float32, device=self.device)
        self.std = torch.as_tensor(channels.STD, dtype=torch.float32, device=self.device)

    @staticmethod
    def hours(ts) -> int:
        if isinstance(ts, datetime):
            return int((ts.replace(tzinfo=None) - datetime(2000, 1, 1)).total_seconds() // 3600)
        return int(ts)

    @torch.no_grad()
    def state(self, ts) -> torch.Tensor:
        """(69, H, W) float32 on the device, physical units."""
        h = self.hours(ts)
        out = torch.empty((channels.N_CHANNELS, *self.hw), device=self.device)
        for c in range(channels.N_CHANNELS):
            torch.add(0.8 * torch.roll(self.base[c], h * int(self.speed1[c]), 1),
                      torch.roll(self.mode2[c], h * int(self.speed2[c]), 1), alpha=0.35,
                      out=out[c])
        return out * self.std[:, None, None] + self.mean[:, None, None]

    def get_state(self, ts) -> np.ndarray:
        return self.state(ts).cpu().numpy()
