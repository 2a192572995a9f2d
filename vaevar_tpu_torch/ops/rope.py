"""Axial 2-D rotary position embedding for windowed attention.

Port of vaevar_tpu/ops/rope.py:16-53: the head dim splits as
[d1, d2, d1, d2] with d1 = (dim//2)//2 rotated by the row coordinate and
d2 = dim//2 - d1 by the column coordinate.
"""

from __future__ import annotations

import numpy as np
import torch


def rope2_tables(window_size, head_dim: int):
    """(sin1, cos1, sin2, cos2) as float32 numpy arrays, each (N, d_i)."""
    h, w = window_size
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    coords = coords.reshape(2, -1)
    half = head_dim // 2
    d1 = half // 2
    d2 = half - d1
    inv1 = 10000.0 ** -(np.arange(d1) / d1)
    inv2 = 10000.0 ** -(np.arange(d2) / d2)
    s1 = coords[0][:, None] * inv1[None, :]
    s2 = coords[1][:, None] * inv2[None, :]
    return tuple(a.astype(np.float32)
                 for a in (np.sin(s1), np.cos(s1), np.sin(s2), np.cos(s2)))


def apply_rope2(x, tables):
    """Rotate the last dim of x (..., N, head_dim); `tables` are float32
    tensors, so a bf16 x comes out float32, as in the JAX package."""
    sin1, cos1, sin2, cos2 = tables
    d1 = sin1.shape[-1]
    d2 = sin2.shape[-1]
    x11 = x[..., :d1]
    x21 = x[..., d1:d1 + d2]
    x12 = x[..., d1 + d2:2 * d1 + d2]
    x22 = x[..., 2 * d1 + d2:]
    return torch.cat([
        x11 * cos1 - x12 * sin1,
        x21 * cos2 - x22 * sin2,
        x12 * cos1 + x11 * sin1,
        x22 * cos2 + x21 * sin2,
    ], dim=-1)
