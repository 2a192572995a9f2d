"""Latitude-weighted evaluation metrics (torch).

Port of vaevar_tpu/utils/metrics.py:19-70, keeping the reference's
degree->radian constant 3.1416 and its regional weighting. Functions take
(B, C, H, W) tensors and return per-channel values (C,) averaged over B.
"""

from __future__ import annotations

import numpy as np
import torch

_DEG = 3.1416 / 180.0  # the reference uses 3.1416, not pi


def _lat_deg(num_lat: int) -> np.ndarray:
    j = np.arange(num_lat, dtype=np.float64)
    return 90.0 - j * 180.0 / (num_lat - 1)


def lat_weights(num_lat: int, region: str = "all") -> tuple[np.ndarray, slice]:
    """cos(lat) weights normalized to mean 1 over the region, plus row slice."""
    coslat = np.cos(_DEG * _lat_deg(num_lat))
    n_idx = int(110.0 / 180.0 * num_lat + 0.5)
    s_idx = int(70.0 / 180.0 * num_lat + 0.5)
    if region == "all":
        sl, scale = slice(None), num_lat
    elif region == "northern":
        sl, scale = slice(n_idx, None), s_idx
    elif region == "southern":
        sl, scale = slice(None, s_idx), s_idx
    elif region == "tropics":
        sl, scale = slice(s_idx, n_idx), n_idx - s_idx
    else:
        raise ValueError(region)
    w = coslat[sl]
    return (scale * w / w.sum()).astype(np.float32), sl


def _weights(num_lat, region, like):
    w, sl = lat_weights(num_lat, region)
    return torch.as_tensor(w, device=like.device).reshape(1, 1, -1, 1), sl


def weighted_rmse(pred, target, region: str = "all"):
    """Latitude-weighted RMSE per channel, batch-averaged. (B,C,H,W) -> (C,)."""
    w, sl = _weights(pred.shape[2], region, pred)
    se = w * (pred[:, :, sl] - target[:, :, sl]) ** 2
    return torch.sqrt(se.mean(dim=(-1, -2))).mean(0)


def weighted_bias(diff, region: str = "all"):
    """Latitude-weighted mean of `diff` per channel. (B,C,H,W) -> (C,)."""
    w, sl = _weights(diff.shape[2], region, diff)
    return (w * diff[:, :, sl]).mean(dim=(-1, -2)).mean(0)
