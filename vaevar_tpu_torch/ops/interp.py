"""Nearest resize with torch `F.interpolate(mode='nearest')` index semantics
(src = floor(dst * in / out)), the rule the reference uses for every grid
change in the DA engine. Port of vaevar_tpu/ops/interp.py:24-36."""

from __future__ import annotations

import numpy as np
import torch


def _nearest_idx(n_out: int, n_in: int) -> np.ndarray:
    return np.minimum((np.arange(n_out) * n_in) // n_out, n_in - 1).astype(np.int64)


def resize_nearest(x, out_hw):
    """Nearest resize on the last two axes of x (..., H, W)."""
    H, W = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    if (oh, ow) == (H, W):
        return x
    hi = torch.as_tensor(_nearest_idx(oh, H), device=x.device)
    wi = torch.as_tensor(_nearest_idx(ow, W), device=x.device)
    return x.index_select(-2, hi).index_select(-1, wi)
