"""Windowing primitives for shifted-window attention (channel-last layout).

Port of vaevar_tpu/ops/windows.py: `window_partition`, `window_reverse`,
`shift2d` on (B, H, W, C) tensors, the numpy Swin shift mask with the
reference's latitude-only quirk (the last longitude slice overwrites the
whole row, so only latitude regions are separated), and
`sd_attention_mask`, a numpy copy of the reference's mask for 3-D windows
and dilated token groups (tests/test_torch_import.py holds it equal).
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


def sd_attention_mask(
    grid, window_size, shift_size, dilated_size=None, neg: float = -np.inf
) -> np.ndarray | None:
    """Static SW-MSA mask for SD_attn's full parameter surface: 2-D or 3-D
    windows and dilated token groups (Attention.py:500-569).

    Returns (nGroups, N, N) additive mask with nGroups = nWin_total *
    prod(dilated) and N = prod(window_size), group order (window-raster,
    dilated-offset-raster) matching SD_attn's batch regrouping
    (Attention.py:543-556,600-609); or None when the reference builds no
    mask (lon shift zero, or the total window spans the full longitude,
    Attention.py:580-589).

    Reference quirks reproduced deliberately:
    - region slices use `window_size`, NOT the dilated total window
      (create_mask slices at Attention.py:511-537 vs the total-window
      partition at :541);
    - the final longitude slice is `slice(0, None)`, overwriting the whole
      row range — longitude is treated as periodic, so labels only
      compartmentalize the leading (time/latitude) axes.
    """
    import itertools

    nd = len(window_size)
    dil = tuple(dilated_size) if dilated_size is not None else (1,) * nd
    total = tuple(w * d for w, d in zip(window_size, dil))
    if shift_size[-1] == 0 or total[-1] == grid[-1]:
        return None

    img = np.zeros(grid, dtype=np.float64)
    ax_slices = [
        (slice(0, -w), slice(-w, -s), slice(-s, None))
        for w, s in zip(window_size[:-1], shift_size[:-1])
    ]
    w_last = window_size[-1]
    ax_slices.append(
        (slice(0, -w_last), slice(-w_last, 0), slice(0, None))
    )
    cnt = 0
    for idx in itertools.product(*ax_slices):
        img[idx] = cnt
        cnt += 1

    # partition by the TOTAL window, then regroup so each dilated offset
    # is one mask row of the window_size-lattice tokens
    rs = []
    for g, w, d in zip(grid, window_size, dil):
        rs += [g // (w * d), w, d]
    lab = img.reshape(rs)
    n_axes = [3 * i for i in range(nd)]
    w_axes = [3 * i + 1 for i in range(nd)]
    d_axes = [3 * i + 2 for i in range(nd)]
    lab = lab.transpose(n_axes + d_axes + w_axes).reshape(
        -1, int(np.prod(window_size))
    )
    mask = lab[:, None, :] - lab[:, :, None]
    return np.where(mask != 0, neg, 0.0).astype(np.float32)
