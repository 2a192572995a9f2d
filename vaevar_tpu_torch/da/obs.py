"""Synthetic observation pipeline: error variance R, model error Q and
masks H (numpy).

Copies of vaevar_tpu/da/obs.py:41-118 (`obs_error_variance`, `build_R`,
`load_q_matrix`) and :124-160 (`make_obs_mask` for the "free_XXXX" and
"column_random_XXXX" families). The reference module imports jax through
ops.interp, so the numpy functions are copied rather than imported.
Real-observation and station families are not ported yet (ROADMAP A.11b).
"""

from __future__ import annotations

import os
import re

import numpy as np

from vaevar_tpu_torch import channels


def obs_error_variance(obs_std: float, modify_tp: int = 0) -> np.ndarray:
    """(69,) obs error variance: obs_std^2 * model std^2 with the
    `modify_tp` per-variable rescalings (da_4dvar.py:106-127)."""
    var = np.full(channels.N_CHANNELS, obs_std**2) * channels.STD**2
    if modify_tp == 1:
        var[56:] /= 4
    elif modify_tp == 2:
        var[56:] /= 16
        var[2] /= 16
    elif modify_tp == 3:
        var[56:] /= 16
        var[2] /= 16
        var[30:56] /= 16
    elif modify_tp == 4:
        var[56:] /= 16
        var[2] /= 16
        var[17:30] /= 4
    return var.astype(np.float32)


def build_R(obs_var: np.ndarray, q_matrix: np.ndarray | None = None,
            da_win: int = 1) -> np.ndarray:
    """R[0] = obs_var; R[t >= 1] += Q[t - 1] (da_4dvar.py:630-635).

    Broadcastable as (da_win, 69, 1, 1); a per-pixel Q (spatial dims > 1)
    broadcasts R out to Q's grid."""
    R = np.broadcast_to(obs_var.reshape(1, -1, 1, 1),
                        (da_win, channels.N_CHANNELS, 1, 1)).copy()
    if da_win > 1 and q_matrix is not None:
        q = np.asarray(q_matrix)[: da_win - 1]
        if q.shape[-2:] != (1, 1):
            R = np.broadcast_to(R, (da_win, channels.N_CHANNELS, *q.shape[-2:])).copy()
        R[1:] += q
    return R.astype(np.float32)


def load_q_matrix(coeff_dir: str, q_type: int, da_win: int) -> np.ndarray | None:
    """Per-lead-time model-error variance (da_4dvar.py:528-550), broadcastable
    as (da_win - 1, 69, 1, 1); None for da_win 1 or q_type -1.

    q_type 1 reads `new_q.npy` (T-1, 69), or without it the synthetic
    fallback linear in lead time; q_type 0 takes the spatial means of the
    `q{i}.npy` fields."""
    if da_win == 1 or q_type == -1:
        return None
    if q_type == 1:
        path = os.path.join(coeff_dir, "new_q.npy")
        if os.path.exists(path):
            q = np.load(path).astype(np.float32)[: da_win - 1]
        else:
            lead = np.arange(1, da_win, dtype=np.float32).reshape(-1, 1)
            q = (0.02 * lead) * channels.ERR_STD.reshape(1, -1) ** 2 * \
                channels.STD.reshape(1, -1) ** 2
        return q.astype(np.float32)[:, :, None, None]
    if q_type == 0:
        qs = []
        for i in range(1, da_win):
            q0 = np.load(os.path.join(coeff_dir, f"q{i}.npy"))
            qs.append(q0.mean((1, 2), keepdims=True))
        return np.stack(qs).astype(np.float32)
    raise NotImplementedError(f"q_type {q_type}")


def make_obs_mask(obs_type: str, da_win: int, hw: tuple[int, int],
                  rng: np.random.Generator) -> np.ndarray:
    """(da_win, 69, H, W) 0/1 mask for the synthetic-obs families."""
    H, W = hw
    if obs_type.startswith("free_"):
        digits = obs_type.split("_")[1]
        amount = int(digits) * (1000 if len(digits) == 4 else 100)
        flat = np.zeros(H * W, np.float32)
        flat[rng.choice(H * W, size=min(amount, H * W), replace=False)] = 1
        return np.broadcast_to(flat.reshape(H, W), (da_win, 69, H, W)).copy()
    m = re.match(r"column_random_(\d+)", obs_type)
    if m:
        frac = int(m.group(1)) * 1e-4  # observed columns per grid point
        amount = max(1, int(round(frac * H * W)))
        flat = np.zeros(H * W, np.float32)
        flat[rng.choice(H * W, size=amount, replace=False)] = 1
        return np.broadcast_to(flat.reshape(H, W), (da_win, 69, H, W)).copy()
    raise NotImplementedError(
        f"obs_type {obs_type!r}: only the synthetic free_/column_random_ "
        "families are ported; mask files, real and prepbufr obs are ROADMAP A.11b")
