"""Sinusoidal positional encodings (1-D/2-D/3-D), the MAE 2-D sin-cos
posemb and the relative-position tables, in numpy.

A copy of vaevar_tpu/ops/posenc.py, kept in the port so that the port runs
without the JAX package (tests/test_torch_import.py holds every function
equal to the reference, source and values). The tables are static constants
that the port's modules turn into tensors.
"""

from __future__ import annotations

import numpy as np


def _axis_emb(n: int, channels: int) -> np.ndarray:
    """(n, 2*ceil(channels/2)) interleaved [sin, cos] embedding of one axis."""
    c = int(np.ceil(channels / 2) * 2)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, c, 2) / c))
    ang = np.arange(n)[:, None] * inv_freq[None, :]  # (n, c/2)
    emb = np.stack([np.sin(ang), np.cos(ang)], axis=-1)  # (n, c/2, 2)
    return emb.reshape(n, -1)


def positional_encoding_1d(length: int, channels: int) -> np.ndarray:
    """(length, channels); reference PositionalEncoding1D (:14-47)."""
    out = np.zeros((length, channels), np.float32)
    emb = _axis_emb(length, channels)
    out[:] = emb[:, :channels]
    return out


def positional_encoding_2d(h: int, w: int, channels: int) -> np.ndarray:
    """(h, w, channels); per-axis groups of ceil(c/4)*2 channels, zero pad
    (reference PositionalEncoding2D, :68-107)."""
    c_axis = int(np.ceil(channels / 4) * 2)
    emb_h = _axis_emb(h, c_axis)[:, :c_axis]
    emb_w = _axis_emb(w, c_axis)[:, :c_axis]
    out = np.zeros((h, w, 2 * c_axis), np.float32)
    out[:, :, :c_axis] = emb_h[:, None, :]
    out[:, :, c_axis : 2 * c_axis] = emb_w[None, :, :]
    return out[:, :, :channels]


def positional_encoding_3d(t: int, h: int, w: int, channels: int) -> np.ndarray:
    """(t, h, w, channels); reference PositionalEncoding3D (:128-182)."""
    c_axis = int(np.ceil(channels / 6) * 2)
    emb_t = _axis_emb(t, c_axis)[:, :c_axis]
    emb_h = _axis_emb(h, c_axis)[:, :c_axis]
    emb_w = _axis_emb(w, c_axis)[:, :c_axis]
    out = np.zeros((t, h, w, 3 * c_axis), np.float32)
    out[..., :c_axis] = emb_t[:, None, None, :]
    out[..., c_axis : 2 * c_axis] = emb_h[None, :, None, :]
    out[..., 2 * c_axis : 3 * c_axis] = emb_w[None, None, :, :]
    return out[..., :channels]


def build_2d_sincos_posemb(h: int, w: int, embed_dim: int = 1024,
                           temperature: float = 10000.0) -> np.ndarray:
    """(1, h*w, embed_dim) MAE-style grid posemb
    (networks/utils/mae_utils.py:29-45): [sin(wx), cos(wx), sin(hy), cos(hy)]
    with embed_dim//4 frequencies per part."""
    assert embed_dim % 4 == 0, "embed_dim must be divisible by 4"
    grid_w = np.arange(w, dtype=np.float32)
    grid_h = np.arange(h, dtype=np.float32)
    gw, gh = np.meshgrid(grid_w, grid_h)  # both (h, w)
    pos_dim = embed_dim // 4
    omega = 1.0 / temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim)
    out_w = gw.reshape(-1)[:, None] * omega[None, :]
    out_h = gh.reshape(-1)[:, None] * omega[None, :]
    emb = np.concatenate(
        [np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1
    )
    return emb[None].astype(np.float32)


def relative_position_onehot(window_size) -> np.ndarray:
    """One-hot (N*N, T) map from window token pair to rel-pos table row.

    The matmul form of the bias lookup: a gather inside an nn.scan'd
    stack lowers to a backward scatter that is ~500x slower than the
    equivalent (N^2, T) x (T, heads) matmul. Shared by the modular
    WindowAttention and the fused Pallas block so the two stay
    bit-identical for checkpoint parity.
    """
    idx = relative_position_index(tuple(window_size)).reshape(-1)
    table_len = 1
    for s in window_size:
        table_len *= 2 * s - 1
    onehot = np.zeros((idx.shape[0], table_len), np.float32)
    onehot[np.arange(idx.shape[0]), idx] = 1.0
    return onehot


def relative_position_index(window_size) -> np.ndarray:
    """(N, N) index into a prod(2*w_i - 1) relative-position-bias table for
    an n-D window (reference RelativePositionalBias index build,
    positional_encodings.py:330-352)."""
    coords = np.stack(
        np.meshgrid(*[np.arange(s) for s in window_size], indexing="ij")
    ).reshape(len(window_size), -1)
    rel = coords[:, :, None] - coords[:, None, :]  # (nd, N, N)
    rel = rel.transpose(1, 2, 0).copy()
    table_len = 1
    for s in window_size:
        table_len *= 2 * s - 1
    for i, s in enumerate(window_size):
        rel[:, :, i] += s - 1
    for i in range(len(window_size) - 1):
        table_len //= 2 * window_size[i] - 1
        rel[:, :, i] *= table_len
    return rel.sum(-1)
