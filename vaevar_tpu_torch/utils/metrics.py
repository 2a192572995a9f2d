"""Latitude-weighted evaluation metrics (torch).

Port of vaevar_tpu/utils/metrics.py, keeping the reference's degree->radian
constant 3.1416, its regional weighting and its quirks. Functions take
(B, C, H, W) tensors and return per-channel values (C,) averaged over B;
`Metrics` and `MetricsRecorder` are the reference's facade by metric name
(normalized fields in, physical units out for WRMSE, Bias and Activity).
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


def weighted_acc(pred, target, region: str = "all"):
    """Latitude-weighted anomaly correlation per channel. (B,C,H,W) -> (C,)."""
    w, sl = _weights(pred.shape[2], region, pred)
    p, t = pred[:, :, sl], target[:, :, sl]
    num = (w * p * t).sum(dim=(-1, -2))
    den = torch.sqrt((w * p * p).sum(dim=(-1, -2)) * (w * t * t).sum(dim=(-1, -2)))
    return (num / den).mean(0)


def weighted_activity(pred, region: str = "all"):
    """Lat-weighted std of `pred` about its weighted mean. (B,C,H,W) -> (C,)."""
    w, sl = _weights(pred.shape[2], region, pred)
    p = pred[:, :, sl]
    mean = (w * p).mean(dim=(-1, -2), keepdim=True)
    return torch.sqrt((w * (p - mean) ** 2).mean(dim=(-1, -2))).mean(0)


def weighted_anomaly(pred, target, region: str = "all"):
    """Lat-weighted anomaly pattern correlation. (B,C,H,W) -> (C,), with the
    reference's quirk of a scalar numerator over all dims and a per-channel
    denominator (utils/metrics.py:118-133)."""
    w, sl = _weights(pred.shape[2], region, pred)
    p, t = pred[:, :, sl], target[:, :, sl]
    pa = p - (w * p).mean(dim=(-1, -2), keepdim=True)
    ta = t - (w * t).mean(dim=(-1, -2), keepdim=True)
    nume = (w * pa * ta).mean()
    deno = torch.sqrt((w * pa ** 2).mean(dim=(-1, -2))) * torch.sqrt(
        (w * ta ** 2).mean(dim=(-1, -2)))
    return (nume / deno).mean(0)


_REGIONS = {"": "all", "N": "northern", "S": "southern", "T": "tropics"}


class Metrics:
    """Reference-compatible facade (utils/metrics.py:363-600): one method per
    metric name with signature (pred, gt, data_mask, clim, data_std). N, S
    and T prefixes select the northern, southern and tropics bands."""

    def __init__(self, epsilon: float = 1e-8, **kwargs):
        self.epsilon = epsilon

    def MSE(self, pred, gt, data_mask=None, clim=None, data_std=None):
        return float(((pred - gt) ** 2).mean())

    def Channel_MSE(self, pred, gt, data_mask=None, clim=None, data_std=None):
        return ((pred - gt) ** 2).mean(dim=(0, 2, 3))

    def Position_MSE(self, pred, gt, data_mask=None, clim=None, data_std=None):
        return ((pred - gt) ** 2).mean(dim=(0, 1)).reshape(-1)

    def RMSE(self, pred, gt, data_mask=None, clim=None, data_std=None):
        # reference quirk: mean over dims (1, 2) then sqrt (metrics.py:416)
        return float(torch.sqrt(((pred - gt) ** 2).mean(dim=(1, 2))).mean())

    def MAE(self, pred, gt, data_mask=None, clim=None, data_std=None):
        return float((pred - gt).abs().mean())

    def __getattr__(self, name):
        """The regional families: {,N,S,T} x {WRMSE, Bias, Activity, WACC,
        Anomaly}."""
        for family in ("WRMSE", "Bias", "Activity", "WACC", "Anomaly"):
            prefix = name[:-len(family)] if name.endswith(family) else None
            if prefix in _REGIONS:
                return lambda pred, gt, data_mask=None, clim=None, data_std=None: \
                    self._regional(family, _REGIONS[prefix], pred, gt, clim, data_std)
        raise AttributeError(name)

    @staticmethod
    def _regional(family, region, pred, gt, clim, data_std):
        s = 1.0 if data_std is None else torch.as_tensor(
            np.asarray(data_std, np.float32), device=pred.device)
        if family == "WRMSE":
            return weighted_rmse(pred, gt, region) * s
        if family == "Bias":
            return weighted_bias(pred - gt, region) * s
        if family == "Activity":
            return weighted_activity(pred - clim, region) * s
        if family == "WACC":
            return weighted_acc(pred - clim, gt - clim, region)
        return weighted_anomaly(pred - clim, gt - clim, region)


class MetricsRecorder:
    """Reference MetricsRecorder (utils/metrics.py:602-663): configured with
    metric names; `evaluate_batch` expands per-channel values into
    `{name + str(channel): scalar}` entries. Fields may be tensors or numpy
    arrays."""

    def __init__(self, metrics_list, epsilon: float = 1e-7, **kwargs):
        self.epsilon = epsilon
        self.metrics = Metrics(epsilon=epsilon)
        self.metric_str_list = list(metrics_list)
        self.metrics_list = []
        for name in metrics_list:
            try:
                fn = getattr(self.metrics, name)
            except AttributeError:
                raise NotImplementedError("Invalid metric type.") from None
            self.metrics_list.append((name, fn))

    def evaluate_batch(self, data_dict):
        pred = torch.as_tensor(data_dict["pred"]).float()
        gt = torch.as_tensor(data_dict["gt"]).float().to(pred.device)
        clim = data_dict.get("clim_mean")
        if clim is not None:
            clim = torch.as_tensor(clim).float().to(pred.device)
        losses = {}
        for name, fn in self.metrics_list:
            val = fn(pred, gt, None, clim, data_dict.get("std"))
            if isinstance(val, (float, int)):
                losses[name] = float(val)
            else:
                for i, v in enumerate(val.reshape(-1).tolist()):
                    losses[name + str(i)] = float(v)
        return losses
