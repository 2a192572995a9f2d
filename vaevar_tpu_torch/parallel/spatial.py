"""The (lat, lon) tiling of a spatially partitioned LGUnet and its halo
exchange (docs/SPATIAL_TRAINING.md).

A `Tiling` is one rank's place on an sh x sw grid of tiles: its tile of any
(..., H, W) field is the JAX trainers' `P(..., "sh", "sw")` placement, rows
[s H/sh, (s+1) H/sh) and columns [w W/sw, (w+1) W/sw), and an uneven tiling
raises (JAX's `device_put` does). `Tiling.roll` is the shifted windows'
cyclic roll of the whole field, computed on the tiles: `halo_roll` moves a
strip of |k| rows (or columns) to the neighbouring rank along the axis, by
an all-gather of the strips over the axis's process group, and its
backward is the roll by -k, so it equals `torch.roll` of the assembled
field bit for bit in both directions. `Tiling.gather` all-gathers a tiled
field into the whole one over the spatial group.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vaevar_tpu_torch.parallel.mesh import _all_gather


def _roll(x, k: int, dim: int, n: int, index: int, group):
    """torch.roll(whole, k, dim) of a field tiled in `n` equal tiles along
    `dim`, computed on tile `index` of them; `group` holds the axis's ranks
    in tile order (None: the world)."""
    t = x.shape[dim]
    if abs(k) > t:
        raise ValueError(f"a roll by {k} reaches past the neighbouring tile of {t}")
    if k > 0:  # the last k rows go to the next tile, the previous tile's come in
        strip, src = x.narrow(dim, t - k, k), (index - 1) % n
    else:  # the first |k| rows go to the previous tile, the next tile's come in
        strip, src = x.narrow(dim, 0, -k), (index + 1) % n
    got = _all_gather(strip, group)[src].to(x.device)
    if k > 0:
        return torch.cat([got, x.narrow(dim, 0, t - k)], dim)
    return torch.cat([x.narrow(dim, -k, t + k), got], dim)


class _HaloRoll(torch.autograd.Function):
    """The roll of a tiled field by k along `dim`; its adjoint is the roll
    by -k, and its tangent rolls with it."""

    @staticmethod
    def forward(x, k, dim, n, index, group):
        return _roll(x, k, dim, n, index, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        k, dim, n, index, group = ctx.args
        return _roll(g, -k, dim, n, index, group), None, None, None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _roll(t, *ctx.args)


def halo_roll(x, k: int, dim: int, n: int, index: int, group=None):
    """torch.roll(whole, k, dim) on this rank's tile `x`, tile `index` of
    `n` along `dim`, with the strip of |k| <= the tile's size exchanged
    over `group` (the axis's ranks in tile order; None: the world);
    differentiable in both modes. One tile (n 1) is torch.roll of x."""
    if k == 0:
        return x
    if n == 1:
        return torch.roll(x, k, dim)
    return _HaloRoll.apply(x, k, dim, n, index, group)


@dataclass(frozen=True)
class Tiling:
    """This rank's tile (s, w) of an sh x sw tiling of every (..., H, W)
    field, with the process groups of its lat axis (the sh ranks of its
    column of tiles), its lon axis (the sw ranks of its row) and its whole
    tiling (`group`); None is the world, as where an axis spans it."""

    sh: int
    sw: int
    s: int = 0
    w: int = 0
    group: object = None
    lat_group: object = None
    lon_group: object = None

    def tile(self, hw, what: str = "a field") -> tuple:
        """(rows, cols) slices of this rank's tile of an (H, W) grid (the
        counterpart of JAX's `nhwc_spec` and `state_spec`, P(sh, sw) on the
        grid's axes); an axis that does not divide the grid raises (JAX
        places P(sh, sw) and refuses an uneven tiling)."""
        out = []
        for n, size, i, dim, axis in ((self.sh, hw[0], self.s, "lat", "sh"),
                                      (self.sw, hw[1], self.w, "lon", "sw")):
            if size % n:
                raise ValueError(f"{what}: its {dim} dim of {size} does not divide over the "
                                 f"mesh axis {axis}={n} (grid {hw[0]}x{hw[1]}); a spatial "
                                 "mesh tiles every level of the model evenly")
            t = size // n
            out.append(slice(i * t, (i + 1) * t))
        return tuple(out)

    def roll(self, x, shift_h: int, shift_w: int):
        """The cyclic shift of the whole (B, H, W, C) field by (shift_h,
        shift_w), on this rank's tile x (`ops/windows.py::shift2d`)."""
        x = halo_roll(x, shift_h, 1, self.sh, self.s, self.lat_group)
        return halo_roll(x, shift_w, 2, self.sw, self.w, self.lon_group)

    def gather(self, x) -> torch.Tensor:
        """The whole (..., H, W) field of this rank's tile x, all-gathered
        over the tiling's group (a collective: every rank of it calls
        this), on x's device, without gradient."""
        if self.sh * self.sw == 1:
            return x.detach()
        parts = [p.to(x.device) for p in _all_gather(x, self.group)]
        rows = [torch.cat(parts[i * self.sw:(i + 1) * self.sw], -1) for i in range(self.sh)]
        return torch.cat(rows, -2)
