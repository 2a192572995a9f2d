"""Observation pipeline: masks H, values yo, error variance R.

Port of vaevar_tpu/da/obs.py (the reference's `data_reader` and obs
handling, da_4dvar.py:97-452, 608-638, 729-805):

- obs error variance with `modify_tp` per-variable rescalings, R with the
  model error Q for a window's later slots;
- three synthetic mask families: "free_XXXX" random points,
  "column_random_XXXX" random columns, and mask files
  `mask_<obs_type>.npy`, which take precedence over the column rule;
- prepbufr-style station reports -> gridded 69-channel mask;
- real-obs gridding onto the 4 + 5 * dim_out level-augmented channels, with
  unit conversions, log-pressure lapse corrections of z and t and
  multi-report averaging, or pre-gridded arrays from disk;
- quality control |yo - gt_aug| < filter_coeff * sigma, on tensors on their
  device (the augmented truth never comes back to the host);
- the obs-space std of the augmented channels.

The numpy functions are copies of the reference's (the reference module
imports jax through ops.interp); tests/test_torch_import.py holds them
equal, and `load_numpy_obs` builds its file stem with datetime instead of
pandas.
"""

from __future__ import annotations

import numbers
import os
import re
from datetime import datetime

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.ops.interp import obs_height_levels, obs_level_interp_matrix

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


# --- synthetic mask families -------------------------------------------------


def make_obs_mask(
    obs_type: str,
    da_win: int,
    hw: tuple[int, int],
    rng: np.random.Generator,
    mask_dir: str | None = None,
) -> np.ndarray:
    """(da_win, 69, H, W) 0/1 mask for the synthetic-obs families."""
    H, W = hw
    if obs_type.startswith("free_"):
        digits = obs_type.split("_")[1]
        amount = int(digits) * (1000 if len(digits) == 4 else 100)
        flat = np.zeros(H * W, np.float32)
        flat[rng.choice(H * W, size=min(amount, H * W), replace=False)] = 1
        m2d = flat.reshape(H, W)
        return np.broadcast_to(m2d, (da_win, 69, H, W)).copy()
    if mask_dir:
        path = os.path.join(mask_dir, f"mask_{obs_type}.npy")
        if os.path.exists(path):
            m = np.load(path).astype(np.float32)
            return (np.zeros((da_win, 69, H, W), np.float32) + m).astype(np.float32)
    m = re.match(r"column_random_(\d+)", obs_type)
    if m:
        # fraction of observed columns = digits * 1e-4 of all grid points
        frac = int(m.group(1)) * 1e-4
        amount = max(1, int(round(frac * H * W)))
        flat = np.zeros(H * W, np.float32)
        flat[rng.choice(H * W, size=amount, replace=False)] = 1
        m2d = flat.reshape(H, W)
        return np.broadcast_to(m2d, (da_win, 69, H, W)).copy()
    if obs_type.startswith("prepbufr"):
        raise ValueError(
            "prepbufr masks come from station reports, not a mask rule: "
            "route through station_mask_from_reports with a reports_source "
            "(cycler.get_obs_info does this automatically)"
        )
    raise FileNotFoundError(f"no mask asset or rule for obs_type={obs_type}")


# --- station (prepbufr-style) gridding ---------------------------------------

_STATION_HEIGHT_BINS = np.array(
    [75, 125, 175, 225, 275, 350, 450, 550, 650, 775, 887.5, 962.5]
)


def _report_fields(elem):
    """(position, value) lists if the report row is well-formed, else None.

    Real prepbufr-derived JSONs vary in schema; the reference's only
    explicit guard is None positions (da_4dvar.py:200-201) — anything else
    malformed crashes it. Here malformed rows are SKIPPED instead:
    missing/renamed keys, short lists, None or non-finite position fields.
    Value-slot falsiness (None/0 = not reported) is handled downstream,
    exactly like the reference's `if elem['value'][k]:` tests."""
    if not isinstance(elem, dict):
        return None
    pos = elem.get("position")
    val = elem.get("value")
    if not isinstance(pos, (list, tuple)) or len(pos) < 4:
        return None
    if not isinstance(val, (list, tuple)) or len(val) < 8:
        return None
    for p in pos[:4]:
        # numbers.Real admits numpy scalars (np.float32 etc.), not just
        # builtin float — report sources often index numpy arrays
        if not isinstance(p, numbers.Real) or isinstance(p, bool):
            return None
        if not np.isfinite(p):
            return None
    return pos, val


def _grid_indices(lon_deg: float, lat_deg: float, hw) -> tuple[int, int]:
    H, W = hw
    lon = int(np.round(lon_deg / 360.0 * W))
    if lon == W:
        lon = 0
    lat = int(np.round((90.0 - lat_deg) / 180.0 * H))
    if lat == H:
        lat = H - 1
    return lat, lon


def _time_slot(dt_hours: float, da_win: int, second_file: bool) -> int | None:
    """Window slot from report time offset (da_4dvar.py:209-224,251-257)."""
    if not second_file:
        if da_win == 1:
            return 0 if -0.5 <= dt_hours < 0.5 else None
        if -0.5 <= dt_hours < 0.5:
            return 0
        if 0.5 <= dt_hours < 1.5:
            return 1
        if 1.5 <= dt_hours < 2.5:
            return 2
        if dt_hours >= 2.5:
            return 3
        return None
    if dt_hours < -2.5:
        return 3
    if -2.5 <= dt_hours < -1.5:
        return 4
    if -1.5 <= dt_hours < -0.5:
        return 5
    return None


def station_mask_from_reports(
    reports: dict, da_win: int, hw=(721, 1440), second_file: bool = False,
    H_out: np.ndarray | None = None,
) -> np.ndarray:
    """Gridded 69-channel mask from prepbufr-style reports
    (da_4dvar.py:190-274). Report format: {'position': [lon, lat, plev, dt],
    'value': [p?, z, q, u, v, t, ?, msl]}."""
    Hm = H_out if H_out is not None else np.zeros((da_win, 69, *hw), np.float32)
    for key in reports:
        fields = _report_fields(reports[key])
        if fields is None:
            continue
        pos, val = fields
        lat, lon = _grid_indices(pos[0], pos[1], hw)
        h = int(np.sum((_STATION_HEIGHT_BINS - pos[2]) <= 0))
        t = _time_slot(pos[3], da_win, second_file)
        if t is None:
            continue
        for vi in range(5):
            if val[1 + vi]:
                Hm[t, 4 + h + 13 * vi, lat, lon] = 1
        if val[7]:
            Hm[t, 3, lat, lon] = 1
    # surface winds/temp mirror the lowest level (da_4dvar.py:272-274)
    Hm[:, 0] = Hm[:, 42]
    Hm[:, 1] = Hm[:, 55]
    Hm[:, 2] = Hm[:, 68]
    return Hm


# --- real-obs gridding (aug 204-channel space) --------------------------------


def _geopotential_coeff(idx: int) -> float:
    """Calibrated for the 40-level obs ladder ONLY (da_4dvar.py:314-321):
    the idx thresholds 0/16 are positions in that specific log-pressure
    ladder. grid_real_obs guards dim_out accordingly."""
    if idx == 0:
        return 61245.0
    if idx <= 16:
        return 62000.0
    return 927.87 * idx + 47138.48


def _temperature_coeff(idx: int) -> float:
    """Calibrated for the 40-level obs ladder ONLY (da_4dvar.py:322-326)."""
    return 0.0 if idx <= 21 else -25.0


def grid_real_obs(
    reports_list: list[dict], da_win: int, dim_out: int = 40, hw=(721, 1440)
) -> tuple[np.ndarray, np.ndarray]:
    """(obs, H) on the augmented (4+5*dim_out)-channel grid
    (da_4dvar.py:301-440): unit conversions (z*9.8, q*1e-6, t+273.15,
    msl*100), log-pressure lapse corrections for z and t, multi-report
    averaging per cell."""
    if dim_out != 40:
        # the z/t lapse-correction coefficients hard-code thresholds that
        # are only meaningful at positions in the 40-level ladder; any
        # other dim_out would silently mis-correct every z/t report
        raise ValueError(
            f"grid_real_obs lapse corrections are calibrated for the "
            f"40-level obs ladder (got dim_out={dim_out}); use "
            f"interp_dim=40 with real observations"
        )
    C = 4 + 5 * dim_out
    Hm = np.zeros((da_win, C, *hw), np.float32)
    cnt = np.zeros((da_win, C, *hw), np.float32) + 1e-10
    obs = np.zeros((da_win, C, *hw), np.float32)
    levels = obs_height_levels(dim_out)
    bins = np.sqrt(levels[:-1] * levels[1:])
    geo = [_geopotential_coeff(i) for i in range(dim_out)]
    tmp = [_temperature_coeff(i) for i in range(dim_out)]

    def assign(t, layer, lat, lon, value):
        Hm[t, layer, lat, lon] = 1
        cnt[t, layer, lat, lon] += 1
        obs[t, layer, lat, lon] += value

    for fi, reports in enumerate(reports_list):
        for key in reports:
            fields = _report_fields(reports[key])
            if fields is None:
                continue
            pos, val = fields
            if (not isinstance(val[0], numbers.Real)
                    or isinstance(val[0], bool)
                    or not np.isfinite(val[0]) or val[0] <= 0):
                continue  # pressure anchors level binning AND z/t lapse
            lat, lon = _grid_indices(pos[0], pos[1], hw)
            h = int(np.sum((bins - val[0]) <= 0))
            t = _time_slot(pos[3], da_win, second_file=fi > 0)
            if t is None:
                continue
            for vi in range(5):
                if val[1 + vi]:
                    layer = 4 + h + vi * dim_out
                    v = val[1 + vi]
                    if vi == 0:
                        v = v * 9.8 + geo[h] * (np.log(val[0]) - np.log(levels[h]))
                    elif vi == 1:
                        v = v * 1e-6
                    elif vi == 4:
                        v = v + 273.15 + tmp[h] * (np.log(val[0]) - np.log(levels[h]))
                    assign(t, layer, lat, lon, v)
            if val[-1]:
                assign(t, 3, lat, lon, val[-1] * 100.0)
            if h == dim_out - 1:
                for si in range(3):
                    if val[si + 3]:
                        v = val[si + 3] + (273.15 if si == 2 else 0.0)
                        assign(t, si, lat, lon, v)

    return obs / cnt, Hm


def load_numpy_obs(root: str, ts, da_win: int) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """Pre-gridded observation arrays from disk, the reference's
    `--obs_from_numpy` path (da_4dvar.py:179-190,302-304) with the S3 bucket
    replaced by a local directory of the same layout:
    `{root}/{year}/{YYYY-MM-DDTHH}-obs.npy` and `...-mask.npy`, each
    (da_win, C_obs, H, W). The result feeds the same QC/simu pipeline as
    station gridding."""
    t = ts if isinstance(ts, datetime) else datetime.fromisoformat(str(ts))
    stem = os.path.join(root, str(t.year), t.strftime("%Y-%m-%dT%H"))
    yo = np.load(stem + "-obs.npy").astype(np.float32)
    H = np.load(stem + "-mask.npy").astype(np.float32)
    if yo.shape[0] < da_win or H.shape[0] < da_win:
        raise ValueError(
            f"{stem}: obs has {yo.shape[0]} and mask {H.shape[0]} slots, "
            f"need da_win={da_win}"
        )
    return yo[:da_win], H[:da_win]


def qc_filter(yo, gt_aug, Hm, filter_coeff: float, obs_type: str,
              std_layer_aug: np.ndarray):
    """Gross-error check: keep obs with |yo - gt| < c * sigma
    (da_4dvar.py:778-798). Tensors in, the filtered mask out, on their
    device; the "real_simuz" variants keep every z obs (channels 4:44),
    "real_simu_nofiltering" keeps all."""
    keep_z = obs_type.startswith(("real_simu_nofilteringz", "real_simuz"))
    if not keep_z and obs_type.startswith("real_simu_nofiltering"):
        return Hm.clone()
    std = torch.as_tensor(std_layer_aug, dtype=yo.dtype, device=yo.device)
    keep = (torch.abs(yo - gt_aug) < filter_coeff * std.reshape(1, -1, 1, 1)).to(yo.dtype)
    if keep_z:
        keep[:, 4:44] = 1
    return Hm * keep


def std_layer_augmented(dim_out: int = 40) -> np.ndarray:
    """(4+5*dim_out,) per-channel std in obs space (da_4dvar.py:135-138)."""
    m = obs_level_interp_matrix(dim_out)
    parts = [channels.STD[:4]]
    for i in range(5):
        parts.append(m @ channels.STD[4 + 13 * i : 17 + 13 * i])
    return np.concatenate(parts).astype(np.float32)
