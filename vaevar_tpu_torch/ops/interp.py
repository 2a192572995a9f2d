"""Resize and observation-level interpolation operators.

Port of vaevar_tpu/ops/interp.py. `resize_nearest` has torch
`F.interpolate(mode='nearest')` index semantics (src = floor(dst * in /
out)), the rule the reference uses for every grid change in the DA engine.
`resize_bilinear` is `jax.image.resize(..., "bilinear")`: half-pixel
centres, and a triangle kernel widened by the scale when it downsamples
(antialiasing, which `F.interpolate` does only when asked, and it places
its samples otherwise: ~1e-5 off the reference at 32 -> 90).

`obs_level_interp_matrix` builds the log-pressure linear interpolation
between the 13 model levels and `dim_out` observation levels (reference
obs_interpolater, da_4dvar.py:62-94); `augment_levels` applies it to each
upper-air block, a `torch.einsum` per block (the reference's `jnp.einsum`,
not a kernel). The level ladder and the matrices are numpy copies of the
reference's (tests/test_torch_import.py holds them equal).
"""

from __future__ import annotations

import numpy as np
import torch

from vaevar_tpu_torch.channels import N_LEVELS, N_SINGLE, PRESSURE_LEVELS


def _nearest_idx(n_out: int, n_in: int) -> np.ndarray:
    return np.minimum((np.arange(n_out) * n_in) // n_out, n_in - 1).astype(np.int64)


def resize_nearest(x, out_hw, tile=None):
    """Nearest resize on the last two axes of x (..., H, W). With a `tile`
    of the output grid (parallel/mesh.py::tile_for), only the tile's rows
    and columns of the output: the slice of the whole output, bit for bit."""
    H, W = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    if (oh, ow) == (H, W):
        return x if tile is None else x[..., tile.rows, tile.cols]
    hi, wi = _nearest_idx(oh, H), _nearest_idx(ow, W)
    if tile is not None:
        hi, wi = hi[tile.rows], wi[tile.cols]
    return (x.index_select(-2, torch.as_tensor(hi, device=x.device))
            .index_select(-1, torch.as_tensor(wi, device=x.device)))


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of jax.image.resize's "bilinear" on one axis:
    the triangle kernel at half-pixel centres, widened by in/out when
    downsampling, normalised per output, zero for samples outside the input.
    Computed in float32 step for step as the reference computes them (its
    sample positions carry ~3e-6 of f32 error at 32 -> 90, which float64
    weights would not reproduce)."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale \
        - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / np.maximum(inv_scale, f32(1.0))
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(dist))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x, out_hw):
    """Bilinear resize on the last two axes of x (..., H, W) with the
    semantics of jax.image.resize(..., "bilinear"): half-pixel centres
    (align_corners=False), antialiased when downsampling; two separable
    products with the weights of `_bilinear_weights`."""
    H, W = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    wh = torch.as_tensor(_bilinear_weights(H, oh), dtype=x.dtype, device=x.device)
    ww = torch.as_tensor(_bilinear_weights(W, ow), dtype=x.dtype, device=x.device)
    return torch.einsum("...hw,hi->...iw", x, wh) @ ww


def obs_height_levels(dim_out: int = 40) -> np.ndarray:
    """Log-spaced observation pressure levels (reference da_4dvar.py:68)."""
    return np.round(np.exp(np.linspace(3.91202301, 6.90775528, dim_out)))


def obs_level_interp_matrix(dim_out: int = 40) -> np.ndarray:
    """(dim_out, 13) log-pressure linear interp from model to obs levels."""
    src = np.asarray(PRESSURE_LEVELS, dtype=np.float64)
    dst = obs_height_levels(dim_out)
    return _log_linear_matrix(dst, src)


def obs_level_interp_matrix_inv(dim_out: int = 40) -> np.ndarray:
    """(13, dim_out) log-pressure linear interp from obs back to model levels."""
    src = obs_height_levels(dim_out)
    dst = np.asarray(PRESSURE_LEVELS, dtype=np.float64)
    return _log_linear_matrix(dst, src)


def _log_linear_matrix(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    m = np.zeros((len(dst), len(src)))
    for i, d in enumerate(dst):
        for j in range(len(src)):
            if d == src[j]:
                m[i, j] = 1.0
            elif j + 1 < len(src) and src[j] < d < src[j + 1]:
                m[i, j] = (np.log(src[j + 1]) - np.log(d)) / (
                    np.log(src[j + 1]) - np.log(src[j])
                )
                m[i, j + 1] = (np.log(d) - np.log(src[j])) / (
                    np.log(src[j + 1]) - np.log(src[j])
                )
    return m.astype(np.float32)


def augment_levels(x, interp_matrix):
    """Map (..., 69, H, W) to (..., 4 + 5 * dim_out, H, W) obs space.

    Applies the level-interp matrix (dim_out, 13) to each of the 5 upper-air
    variable blocks; surface channels pass through (da_4dvar.py:770-776)."""
    m = torch.as_tensor(interp_matrix, dtype=x.dtype, device=x.device)
    parts = [x[..., :N_SINGLE, :, :]]
    for i in range(5):
        blk = x[..., N_SINGLE + i * N_LEVELS: N_SINGLE + (i + 1) * N_LEVELS, :, :]
        parts.append(torch.einsum("lk,...khw->...lhw", m, blk))
    return torch.cat(parts, dim=-3)
