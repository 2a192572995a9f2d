"""The vae4dvar 3D-Var cost on the reduced observation quadratic.

Port of vaevar_tpu/da/cost.py:36-87 and :401-437:

    x0 = xb + up(decoder(z) * err_std * model_std)
    J(z) = 1/2 ||z||^2 + obs_coeff * Jo,
    Jo = 1/2 sum_cells [a e^2 - 2 b e] + c/2  (e the low-res increment)

For nearest upsampling the analysis is constant per solver cell, so the
full-resolution obs term reduces exactly onto the solver grid once per
cycle (`reduce_obs`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.ops.interp import _nearest_idx, resize_nearest


class ObsBundle(NamedTuple):
    """Per-cycle data: background and observations."""

    xb: torch.Tensor  # (69, H, W)
    yo: torch.Tensor  # (T, 69, H, W)
    H: torch.Tensor  # (T, 69, H, W) 0/1 mask
    R: torch.Tensor  # (T, 69, 1, 1) obs error variance


class ReducedObs(NamedTuple):
    """Obs term reduced onto the solver grid: per cell a = sum H/R,
    b = sum (H/R)(yo - xb); c = sum (H/R)(yo - xb)^2 over everything."""

    xb: torch.Tensor  # (69, H, W) full-resolution background
    a: torch.Tensor  # (69, h, w)
    b: torch.Tensor  # (69, h, w)
    c: torch.Tensor  # ()


def reduce_obs(bundle: ObsBundle, low_hw) -> ReducedObs:
    """Exact reduction of (yo, H, R) onto the solver grid (da_win == 1)."""
    xb = bundle.xb
    Hf, Wf = xb.shape[-2:]
    hl, wl = low_hw
    eye_h = np.eye(hl, dtype=np.float32)[_nearest_idx(Hf, hl)]  # (Hf, hl)
    eye_w = np.eye(wl, dtype=np.float32)[_nearest_idx(Wf, wl)]  # (Wf, wl)
    Mh = torch.as_tensor(eye_h, device=xb.device)
    Mw = torch.as_tensor(eye_w, device=xb.device)
    w = bundle.H[0] / bundle.R[0]
    r = bundle.yo[0] - xb

    def down(t):  # sum over the full-resolution cells of each solver cell
        return Mh.T @ (t @ Mw)

    return ReducedObs(xb=xb, a=down(w), b=down(w * r), c=torch.sum(w * r * r))


def make_vae4dvar_cost_reduced(decoder, obs_coeff: float = 1.0):
    """(cost, decode_to_state, cost_parts) on a ReducedObs bundle.

    `decoder` maps z (1, C_lat, h, w) to the normalised increment
    (1, 69, h, w)."""

    def increment(z):
        err = torch.as_tensor(channels.ERR_STD, dtype=torch.float32, device=z.device)
        mstd = torch.as_tensor(channels.STD, dtype=torch.float32, device=z.device)
        return decoder(z)[0].float() * err.reshape(-1, 1, 1) * mstd.reshape(-1, 1, 1)

    def decode_to_state(z, bundle: ReducedObs):
        return bundle.xb + resize_nearest(increment(z), bundle.xb.shape[-2:])

    def obs_quad(e, bundle: ReducedObs):
        return 0.5 * (torch.sum(bundle.a * e * e) - 2.0 * torch.sum(bundle.b * e)
                      + bundle.c)

    def cost(z, bundle: ReducedObs):
        return 0.5 * torch.sum(z ** 2) + obs_coeff * obs_quad(increment(z), bundle)

    def cost_parts(z, bundle: ReducedObs):
        """(Jb, Jo) with Jo unscaled by obs_coeff, like the reference printout."""
        return 0.5 * torch.sum(z ** 2), obs_quad(increment(z), bundle)

    return cost, decode_to_state, cost_parts
