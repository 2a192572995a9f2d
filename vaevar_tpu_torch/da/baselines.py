"""Non-variational DA baselines: free_run and interpolation.

Port of vaevar_tpu/da/baselines.py. free_run scores the background as the
analysis (da_4dvar.py:942-966). interpolation fills unobserved grid points
per channel by scipy's linear griddata with the background as fallback
(da_4dvar.py:968-1061); as in the reference it is a host-side CPU baseline,
not a device kernel, and with real obs it augments the background through
the port's own `augment_levels` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from vaevar_tpu_torch.ops.interp import (
    augment_levels,
    obs_level_interp_matrix,
    obs_level_interp_matrix_inv,
)


def free_run_analysis(xb):
    return xb


def interpolation_analysis(
    xb: np.ndarray,
    yo: np.ndarray,
    H: np.ndarray,
    real_obs: bool = False,
    dim_out: int = 40,
    min_known: int = 10,
) -> np.ndarray:
    """Per-layer linear interpolation of observed values onto the grid.

    xb: (69, H, W); yo, H: (C_obs, H, W) at slot 0. When `real_obs`, the
    background is augmented to obs levels first and mapped back after.
    """
    from scipy.interpolate import griddata

    if real_obs:
        m = obs_level_interp_matrix(dim_out)
        xb0 = augment_levels(torch.as_tensor(np.asarray(xb, np.float32)[None]), m)[0].numpy()
    else:
        xb0 = np.asarray(xb)

    xa = xb0.copy()
    C = yo.shape[0]
    for i in range(C):
        b = H[i]
        known = yo[i][b == 1]
        if len(known) <= min_known:
            continue
        known_xy = np.argwhere(b == 1)
        unknown_xy = np.argwhere(b == 0)
        filled = griddata(known_xy, known, unknown_xy, method="linear")
        xa[i][b == 0] = filled
    bad = np.isnan(xa)
    xa[bad] = xb0[bad]

    if real_obs:
        minv = obs_level_interp_matrix_inv(dim_out)
        parts = [xa[:4]]
        for i in range(5):
            blk = xa[4 + i * dim_out : 4 + (i + 1) * dim_out]
            parts.append(np.einsum("lk,khw->lhw", minv, blk))
        xa = np.concatenate(parts, axis=0)
    return xa
