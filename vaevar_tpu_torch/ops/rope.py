"""Axial 2-D and 3-D rotary position embeddings for windowed attention.

Port of vaevar_tpu/ops/rope.py. rope2: the head dim splits as
[d1, d2, d1, d2] with d1 = (dim//2)//2 rotated by the row coordinate and
d2 = dim//2 - d1 by the column coordinate. rope3: [d12, d12, d3, d12, d12,
d3] with d12 = (dim//2)//3 rotated by the first two coordinates and
d3 = dim//2 - 2*d12 by the third (32, 32, 32 at head dim 192).
`rope3_tables` is a numpy copy of the reference's (tests/test_torch_import.py
holds it equal).
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


def rope3_tables(shape, head_dim: int):
    """Axial 3D rotary tables, reference rope3
    (networks/utils/positional_encodings.py:272-316): head dim split
    [d12, d12, d3, d12, d12, d3] with d12 = (dim//2)//3 rotated by the
    first two coordinates and d3 = dim//2 - 2*d12 by the third."""
    t, h, w = shape
    coords = np.stack(
        np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    ).reshape(3, -1)
    half = head_dim // 2
    d12 = half // 3
    d3 = half - 2 * d12
    inv12 = 10000.0 ** -(np.arange(d12) / d12)
    inv3 = 10000.0 ** -(np.arange(d3) / d3)
    mk = lambda c, inv: c[:, None] * inv[None, :]
    s1, s2, s3 = mk(coords[0], inv12), mk(coords[1], inv12), mk(coords[2], inv3)
    f = lambda a: a.astype(np.float32)
    return (
        f(np.sin(s1)), f(np.cos(s1)),
        f(np.sin(s2)), f(np.cos(s2)),
        f(np.sin(s3)), f(np.cos(s3)),
    )


def apply_rope3(x, tables):
    """Rotate the last dim of x (..., N, head_dim) by 3-D position; float32
    `tables` make a bf16 x come out float32, as in the JAX package."""
    sin1, cos1, sin2, cos2, sin3, cos3 = tables
    d12 = sin1.shape[-1]
    half = 2 * d12 + sin3.shape[-1]
    x11 = x[..., :d12]
    x21 = x[..., d12:2 * d12]
    x31 = x[..., 2 * d12:half]
    x12 = x[..., half:half + d12]
    x22 = x[..., half + d12:half + 2 * d12]
    x32 = x[..., half + 2 * d12:]
    return torch.cat([
        x11 * cos1 - x12 * sin1,
        x21 * cos2 - x22 * sin2,
        x31 * cos3 - x32 * sin3,
        x12 * cos1 + x11 * sin1,
        x22 * cos2 + x21 * sin2,
        x32 * cos3 + x31 * sin3,
    ], dim=-1)
