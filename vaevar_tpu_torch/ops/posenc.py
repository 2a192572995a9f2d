"""Relative-position index of the old-gen window bias (numpy).

A copy of vaevar_tpu/ops/posenc.py::relative_position_index, kept in the port
so that the port runs without the JAX package."""

from __future__ import annotations

import numpy as np


def relative_position_index(window_size) -> np.ndarray:
    """(N, N) index into a prod(2*w_i - 1) relative-position-bias table."""
    coords = np.stack(
        np.meshgrid(*[np.arange(s) for s in window_size], indexing="ij")
    ).reshape(len(window_size), -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).copy()
    table_len = 1
    for s in window_size:
        table_len *= 2 * s - 1
    for i, s in enumerate(window_size):
        rel[:, :, i] += s - 1
    for i in range(len(window_size) - 1):
        table_len //= 2 * window_size[i] - 1
        rel[:, :, i] *= table_len
    return rel.sum(-1)
