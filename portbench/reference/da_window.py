"""Plain reference of the 4D-Var window cost (vae4dvar, da_win > 1).

The reference repository's da_4dvar.py, written out directly, not through
the program's reduced algebra (the cell-centred obs term on the solver
grid, the resampling gather):

- the state of a control z at slot 0: x_0 = xb + up(decoder(z) err_std
  std) (:1185-1188), `up` the nearest resize (reference/da.py);
- the hourly rollout inside the cost (:1190-1194, `integrate` :666-681):
  x_t = F(x_{t-1}) for t = 1 .. da_win - 1, F normalising the physical
  state, resizing it to the flow model's grid (nearest), taking the flow
  model's first 69 output channels, resizing back and denormalising;
- the obs error variance of slot t: R_t = obs_std^2 std^2 (modify_tp 2
  dividing channels 56: and channel 2 by 16), plus for t >= 1 the model
  error Q of lead t (:520-550, q_type 1). Departure: the source reads Q
  from new_q.npy, which the benchmark does not have; the program then
  takes Q_t = 0.02 t err_std^2 std^2 (vaevar_tpu_torch/da/obs.py's
  fallback), and so does this reference;
- the observations: column_random_XXXX columns drawn once a cycle
  (reference/da.py::column_draws), every channel observed in every slot,
  at slot t's truth (the program broadcasts one mask over the window);
- J(z) = 1/2 |z|^2 + obs_coeff Jo, Jo = sum_t 1/2 sum_obs (x_t - yo_t)^2 / R_t
  at the observed columns, summed in float64 (departure: the source sums in
  float32 over the full grid's masked points; the float64 sum over the
  observed points is the same sum without its rounding);
- the gradient by autograd through the decoder and every flow step, with
  no checkpoint (the source checkpoints nothing either).

Float32 throughout with TF32 off (`reference/lgunet.py::strict_float32`);
`precision="fp8"` runs the models' products in float8, the control.
"""

from __future__ import annotations

import numpy as np
import torch

from . import channels
from . import da as rda


def obs_variances(obs_std: float, modify_tp: int, da_win: int) -> np.ndarray:
    """(da_win, 69) R_t: the obs error variance, plus Q of lead t for t >= 1."""
    var = rda.obs_error_variance(obs_std, modify_tp)
    lead = np.arange(da_win, dtype=np.float64)[:, None]
    return var[None] + 0.02 * lead * (channels.ERR_STD * channels.STD)[None] ** 2


def resize(x, hw):
    """Nearest resize of (..., h, w) to hw: source index floor(i n_in / n_out)."""
    rows = torch.as_tensor(rda.cell_of(hw[0], x.shape[-2]), device=x.device)
    cols = torch.as_tensor(rda.cell_of(hw[1], x.shape[-1]), device=x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def flow_step(flow, x, low_hw, precision="fp32"):
    """One hour of the flow model on a physical state (69, H, W)."""
    mean = torch.as_tensor(channels.MEAN, dtype=torch.float32, device=x.device)[:, None, None]
    std = torch.as_tensor(channels.STD, dtype=torch.float32, device=x.device)[:, None, None]
    hw = x.shape[-2:]
    out = flow(resize((x - mean) / std, low_hw)[None], precision)[0, :channels.N_CHANNELS]
    return resize(out, hw) * std + mean


class WindowObs:
    """The window's observations: slot t's truth at the cycle's columns and
    R_t, against which `value` scores the slots' states."""

    def __init__(self, truths, columns, variances):
        self.cols = torch.as_tensor(columns, device=truths[0].device)
        self.yo = [t.reshape(channels.N_CHANNELS, -1)[:, self.cols].double() for t in truths]
        self.inv_r = 1.0 / torch.as_tensor(variances, dtype=torch.float64,
                                           device=truths[0].device)[:, :, None]

    def slot(self, t, x):
        """1/2 sum_obs (x - yo_t)^2 / R_t of the state x (69, H, W), float64."""
        d = x.reshape(channels.N_CHANNELS, -1)[:, self.cols].double() - self.yo[t]
        return 0.5 * (self.inv_r[t] * d * d).sum()


def rollout_jo(flow, x0, obs: WindowObs, low_hw, precision="fp32"):
    """(Jo as a float64 tensor, the last slot's state) of the rollout from x0."""
    x, jo = x0, obs.slot(0, x0)
    for t in range(1, len(obs.yo)):
        x = flow_step(flow, x, low_hw, precision)
        jo = jo + obs.slot(t, x)
    return jo, x


def window_cost(decoder, flow, z, xb, obs: WindowObs, obs_coeff=1.0, precision="fp32",
                grad=False):
    """{"j", "jb", "jo" (floats), "last" (the last slot's state), "grad"
    (dJ/dz, with `grad`)} at the control z."""
    scale = torch.as_tensor(channels.ERR_STD * channels.STD, dtype=torch.float32,
                            device=z.device)[:, None, None]
    low_hw = z.shape[-2:]
    with torch.set_grad_enabled(grad):
        zg = z.detach().requires_grad_(grad)
        e = decoder(zg, precision)[0].float() * scale
        jo, last = rollout_jo(flow, xb + rda.upsample(e, xb.shape[-2:]), obs, low_hw, precision)
        jb = 0.5 * (zg.double() ** 2).sum()
        j = jb + obs_coeff * jo
        g = torch.autograd.grad(j, zg)[0].float() if grad else None
    return {"j": float(j.detach()), "jb": float(jb.detach()), "jo": float(jo.detach()),
            "last": last.detach(), "grad": g}


@torch.no_grad()
def background_jo(flow, xb, obs: WindowObs, low_hw, precision="fp32"):
    """Jo of the background's own rollout: the part of Jo no increment sets."""
    return float(rollout_jo(flow, xb, obs, low_hw, precision)[0])
