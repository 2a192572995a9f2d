"""Windowing primitives for shifted-window attention (channel-last layout).

Port of vaevar_tpu/ops/windows.py:19-76: `window_partition`,
`window_reverse`, `shift2d` on (B, H, W, C) tensors, and the numpy Swin
shift mask with the reference's latitude-only quirk (the last longitude
slice overwrites the whole row, so only latitude regions are separated).
"""

from __future__ import annotations

import numpy as np
import torch


def window_partition(x, window_size):
    """(B, H, W, C) -> (B*nWin, wh*ww, C). wh|H and ww|W must hold."""
    B, H, W, C = x.shape
    wh, ww = window_size
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def window_reverse(windows, window_size, H, W):
    """(B*nWin, wh*ww, C) -> (B, H, W, C)."""
    wh, ww = window_size
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // wh) * (W // ww))
    x = windows.reshape(B, H // wh, W // ww, wh, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def shift2d(x, shift_h: int, shift_w: int):
    """Cyclic shift on (B, H, W, C); negative = forward Swin shift."""
    if shift_h == 0 and shift_w == 0:
        return x
    return torch.roll(x, shifts=(shift_h, shift_w), dims=(1, 2))


def swin_attention_mask(H: int, W: int, window_size, shift_size,
                        neg: float = -np.inf) -> np.ndarray | None:
    """Static (nWin, N, N) additive mask (0 / `neg`), or None when the shift
    is zero or the window spans the full longitude."""
    wh, ww = window_size
    sh, sw = shift_size
    if sw == 0 and sh == 0:
        return None
    if ww == W:
        return None
    img = np.zeros((H, W), dtype=np.float64)
    h_slices = (slice(0, H - wh), slice(H - wh, H - sh), slice(H - sh, H))
    for i, hs in enumerate(h_slices):
        img[hs, :] = 3 * i + 2
    wins = img.reshape(H // wh, wh, W // ww, ww).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, wh * ww)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, neg, 0.0).astype(np.float32)
