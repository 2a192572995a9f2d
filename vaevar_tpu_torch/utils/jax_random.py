"""The JAX package's random draws, computed with torch.

`jax.random` with its default implementation (threefry2x32, partitionable
bits) is a counter-based generator: a key is two uint32 words, `fold_in`
hashes an integer into a key, and a draw of a shape hashes the 64-bit index
of each element with the key. This module computes the same keys and draws
(here in int64 tensors holding uint32 values), so the port can replay a JAX
run's noise on any device:
- `prng_key(seed)`: `jax.random.PRNGKey(seed)` as a pair of Python ints;
- `fold_in(key, data)`: `jax.random.fold_in`;
- `normal(key, shape)`: `jax.random.normal(key, shape, float32)`: the same
  uniforms bit for bit, and XLA's inverse error function within a few ulp.
  `rows=(start, stop)` computes only those rows of the first axis, equal
  to the same rows of the whole draw: a data-parallel rank draws its own
  rows of the global batch's noise and nothing more.
- `uniform(key, shape, minval, maxval)`: `jax.random.uniform(key, shape,
  float32, minval, maxval)`, bit for bit (the MoE router's jitter).

The VAE trainer draws its reparameterization noise here, as the JAX
trainer does: step j of epoch e from fold_in(fold_in(PRNGKey(seed), e), j).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words x0, x1 (int64 tensors or
    Python ints holding uint32 values) under the key (k0, k1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """jax.random.PRNGKey(seed): the seed's high and low 32 bits."""
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """jax.random.fold_in(key, data): the hash of the counter (0, data)."""
    return _threefry2x32(key[0], key[1], 0, int(data) & _M32)


def _bits(key, shape, device, rows=None):
    """jax.random's 32 random bits per element of `shape` (partitionable),
    or of its rows start:stop along the first axis for `rows=(start, stop)`
    (each element's bits hash its flat index alone)."""
    start, stop = (0, shape[0]) if rows is None else rows
    per_row = math.prod(shape[1:])
    idx = torch.arange(start * per_row, stop * per_row, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape(stop - start, *shape[1:])


def _unit_floats(key, shape, device, rows=None):
    """Floats in [0, 1) from the mantissa bits, bitwise jax.random's."""
    one = (_bits(key, tuple(shape), device, rows) >> 9) | 0x3F800000  # in [1, 2)
    return one.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: tuple[int, int], shape, minval=0.0, maxval=1.0,
            device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval) on `device`:
    floats * (maxval - minval) + minval, clamped below at minval. XLA fuses
    the scale and shift into one rounding (a fused multiply-add); the f32
    product is exact in float64, so it is formed there and rounded once."""
    lo, hi = np.float32(minval), np.float32(maxval)
    y = (_unit_floats(key, shape, device).double() * float(hi - lo) + float(lo)).float()
    return torch.clamp(y, min=float(lo))


# XLA's single-precision inverse error function (Giles' approximation), the
# coefficients of its two branches in w = -log1p(-x^2), highest degree first
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x):
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5):
        p = torch.where(lt, a, b) + p * w
    return p * x


def normal(key: tuple[int, int], shape, device="cpu", rows=None) -> torch.Tensor:
    """jax.random.normal(key, shape, float32) on `device`, or its rows
    start:stop along the first axis for `rows=(start, stop)`: uniform floats
    in (-1, 1) from the mantissa bits (bitwise JAX's), then sqrt(2) erfinv
    with XLA's polynomial (within 4 ulp of JAX's: log1p differs)."""
    floats = _unit_floats(key, shape, device, rows)
    lo = torch.tensor(np.nextafter(np.float32(-1.0), np.float32(0.0)), device=device)
    u = torch.maximum(lo, floats * (1.0 - lo) + lo)
    return _erfinv(u) * np.float32(np.sqrt(2.0))
