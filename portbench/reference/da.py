"""Plain reference of the 3D-Var cycle's arithmetic (vae4dvar, da_win 1).

The reference repository's da_4dvar.py, written out directly:

- observations: `column_random_XXXX` draws, once per cycle in cycle order
  from numpy's default_rng(seed), XXXX * 1e-4 of the grid's columns without
  replacement; every channel of a drawn column is observed, at the truth;
- the obs error variance R = obs_std^2 std^2, with modify_tp 2 dividing
  channels 56: and channel 2 by 16;
- the state of a control z: xb + up(decoder(z) * err_std * std), `up` the
  nearest resize (source index floor(i * n_in / n_out));
- the cost J(z) = 1/2 |z|^2 + obs_coeff * Jo,
  Jo = 1/2 sum H (x - yo)^2 / R over the full grid, which for a state
  constant on each solver cell is 1/2 sum_cells [a e^2 - 2 b e] + c / 2 with
  a = sum H / R, b = sum (H / R)(yo - xb), c = sum (H / R)(yo - xb)^2 over
  the cell's points. Sums in float64. Its gradient is z + obs_coeff
  (de/dz)^T (a e - b).
"""

from __future__ import annotations

import numpy as np
import torch

from . import channels


def obs_error_variance(obs_std: float, modify_tp: int) -> np.ndarray:
    var = np.full(channels.N_CHANNELS, obs_std ** 2) * channels.STD ** 2
    if modify_tp == 2:
        var[56:] /= 16
        var[2] /= 16
    elif modify_tp != 0:
        raise ValueError(f"modify_tp {modify_tp}: the reference covers 0 and 2")
    return var


def column_draws(seed: int, obs_type: str, n_cycles: int, hw) -> list[np.ndarray]:
    """The observed columns of each of the first n_cycles cycles, as flat
    indices into the (H, W) grid."""
    prefix = "column_random_"
    if not obs_type.startswith(prefix):
        raise ValueError(f"obs_type {obs_type!r}: the reference covers column_random_XXXX")
    frac = int(obs_type[len(prefix):]) * 1e-4
    n = hw[0] * hw[1]
    amount = max(1, int(round(frac * n)))
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(n, size=amount, replace=False)) for _ in range(n_cycles)]


def cell_of(n_full: int, n_low: int) -> np.ndarray:
    """The solver cell of each full-resolution row (or column)."""
    return np.minimum(np.arange(n_full) * n_low // n_full, n_low - 1)


def upsample(e, hw):
    """Nearest resize of (C, h, w) to hw."""
    rows = torch.as_tensor(cell_of(hw[0], e.shape[-2]), device=e.device)
    cols = torch.as_tensor(cell_of(hw[1], e.shape[-1]), device=e.device)
    return e[:, rows][:, :, cols]


class ObsTerm:
    """The reduced obs term of one cycle, built from the truth, the drawn
    columns and R, against the background xb (69, H, W)."""

    def __init__(self, truth, xb, columns, obs_var, low_hw):
        H, W = truth.shape[-2:]
        h, w = low_hw
        cols = torch.as_tensor(columns, device=truth.device)
        yo = truth.reshape(channels.N_CHANNELS, -1)[:, cols].double()
        xo = xb.reshape(channels.N_CHANNELS, -1)[:, cols].double()
        inv_r = 1.0 / torch.as_tensor(obs_var, dtype=torch.float64, device=truth.device)
        r = yo - xo
        cell = (torch.as_tensor(cell_of(H, h), device=truth.device)[cols // W] * w
                + torch.as_tensor(cell_of(W, w), device=truth.device)[cols % W])
        a = torch.zeros(channels.N_CHANNELS, h * w, dtype=torch.float64, device=truth.device)
        b = torch.zeros_like(a)
        a.index_add_(1, cell, inv_r[:, None].expand(-1, len(columns)).contiguous())
        b.index_add_(1, cell, inv_r[:, None] * r)
        self.a, self.b = a.reshape(-1, h, w), b.reshape(-1, h, w)
        self.c = float((inv_r[:, None] * r * r).sum())

    def value(self, e):
        """Jo of the low-res increment e (69, h, w)."""
        e = e.double()
        return 0.5 * float((self.a * e * e).sum() - 2.0 * (self.b * e).sum()) + 0.5 * self.c


def increment(decoder, z, precision="fp32"):
    """The low-res physical increment (69, h, w) of the control z."""
    with torch.no_grad():
        out = decoder(z, precision)[0].float()
    scale = torch.as_tensor(channels.ERR_STD * channels.STD, dtype=torch.float32,
                            device=out.device)
    return out * scale[:, None, None]


def gradient(decoder, z, obs: ObsTerm, obs_coeff: float = 1.0, precision="fp32"):
    """dJ/dz at the control z: z + obs_coeff (de/dz)^T (a e - b), the
    decoder's vector-Jacobian product by autograd."""
    scale = torch.as_tensor(channels.ERR_STD * channels.STD, dtype=torch.float32,
                            device=z.device)[:, None, None]
    with torch.enable_grad():
        zg = z.detach().requires_grad_(True)
        e = decoder(zg, precision)[0].float() * scale
        de = (obs.a * e.detach().double() - obs.b).float()
        (g,) = torch.autograd.grad(e, zg, de)
    return z + obs_coeff * g


def cost(z, e, obs: ObsTerm, obs_coeff: float = 1.0):
    """(J, Jb, Jo) at the control z with its increment e."""
    jb = 0.5 * float((z.double() ** 2).sum())
    jo = obs.value(e)
    return jb + obs_coeff * jo, jb, jo


def advance(forecast, xa, precision="fp32"):
    """One 6 h step of the forecast model on a physical state (69, H, W):
    normalise, the model's first 69 output channels, denormalise."""
    mean = torch.as_tensor(channels.MEAN, dtype=torch.float32, device=xa.device)[:, None, None]
    std = torch.as_tensor(channels.STD, dtype=torch.float32, device=xa.device)[:, None, None]
    with torch.no_grad():
        out = forecast(((xa - mean) / std)[None], precision)[0, :channels.N_CHANNELS]
    return out * std + mean
