"""Forecast integration on physical fields.

Port of vaevar_tpu/da/dynamics.py:25-58: normalise, apply the model `steps`
times keeping the first 69 output channels (the mean head), denormalise,
with an optional nearest resize to and from the model's grid.
"""

from __future__ import annotations

import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.ops.interp import resize_nearest


def make_integrate(model: torch.nn.Module, model_hw=None):
    """integrate(x, steps, interpolation) for x (69, H, W) in physical units."""

    def integrate(x, steps: int, interpolation: bool = False):
        mean = torch.as_tensor(channels.MEAN, dtype=torch.float32,
                               device=x.device).reshape(-1, 1, 1)
        std = torch.as_tensor(channels.STD, dtype=torch.float32,
                              device=x.device).reshape(-1, 1, 1)
        hw = tuple(x.shape[-2:])
        z = ((x - mean) / std)[None]
        resize = interpolation and model_hw is not None and hw != tuple(model_hw)
        if resize:
            z = resize_nearest(z, model_hw)
        for _ in range(steps):
            z = model(z)[:, : channels.N_CHANNELS]
        if resize:
            z = resize_nearest(z, hw)
        return z[0] * std + mean

    return integrate
