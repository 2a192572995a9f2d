"""The (lat, lon) tiling of a spatially partitioned LGUnet and its data
movement (docs/SPATIAL_TRAINING.md).

A `Tiling` is one rank's place on an sh x sw grid of tiles: its tile of any
(..., H, W) field is the JAX trainers' `P(..., "sh", "sw")` placement, rows
[s H/sh, (s+1) H/sh) and columns [w W/sw, (w+1) W/sw), and an uneven tiling
raises (JAX's `device_put` does). A level of the network whose even tile
would cut its attention windows runs on window-aligned tiles instead
(`Tiling.layout`, a `Layout`): its window rows (columns) split over the
axis as evenly as they go, the first ranks taking one more. `retile` moves
a field between two layouts of one level, and its backward is the move
back. `Tiling.roll` is the shifted windows' cyclic roll of the whole field,
computed on the tiles, even or uneven: `halo_roll` moves a strip of |k|
rows (or columns) to the neighbouring rank along the axis, by an all-gather
of the strips over the axis's process group, and its backward is the roll
by -k. `gather_whole` all-gathers a tiled (B, H, W, C) activation into the
whole one on every rank (a full-grid stage runs on it) and its backward
sums the ranks' gradients of the whole and keeps the tile. Every move of
data equals its counterpart on the assembled field bit for bit, in both
directions. `Tiling.gather` all-gathers a tiled field into the whole one
over the spatial group, without gradient.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vaevar_tpu_torch.parallel.mesh import _all_gather, all_sum


def _roll(x, k: int, dim: int, n: int, index: int, group):
    """torch.roll(whole, k, dim) of a field tiled in `n` tiles along `dim`,
    each at least |k| long, computed on tile `index` of them; `group` holds
    the axis's ranks in tile order (None: the world). Every rank's strip is
    |k| long, so the all-gather's parts agree in shape on uneven tiles."""
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
    `n` along `dim` (even or uneven), with the strip of |k| <= every tile's
    size exchanged
    over `group` (the axis's ranks in tile order; None: the world);
    differentiable in both modes. One tile (n 1) is torch.roll of x."""
    if k == 0:
        return x
    if n == 1:
        return torch.roll(x, k, dim)
    return _HaloRoll.apply(x, k, dim, n, index, group)


def split(size: int, n: int, window: int | None = None) -> tuple | None:
    """The rows (or columns) each of `n` ranks holds of an axis of `size`:
    equal tiles (JAX's P placement) where they divide it and hold whole
    windows of `window` (None: no window), else the axis's whole windows
    split as evenly as they go, the first ranks taking one more. None where
    neither can be: fewer windows than ranks, or a window that does not
    divide the axis."""
    if size % n == 0 and (window is None or (size // n) % window == 0):
        return (size // n,) * n
    if window is None or size % window or size // window < n:
        return None
    q, r = divmod(size // window, n)
    return tuple((q + (i < r)) * window for i in range(n))


def _starts(counts):
    out, at = [], 0
    for c in counts:
        out.append(at)
        at += c
    return out


@dataclass(frozen=True)
class Layout:
    """How a level's (H, W) grid is tiled over the sh x sw ranks: the rows
    of each lat rank and the columns of each lon rank, in rank order."""

    rows: tuple
    cols: tuple

    def tile(self, s: int, w: int) -> tuple:
        """(rows, cols) slices of tile (s, w)."""
        r0, c0 = _starts(self.rows)[s], _starts(self.cols)[w]
        return slice(r0, r0 + self.rows[s]), slice(c0, c0 + self.cols[w])

    def halved(self) -> "Layout":
        """The same tiles on a grid of half the size (PatchMerging's output;
        the tiles PatchExpand doubles into these); needs even tiles."""
        return Layout(tuple(c // 2 for c in self.rows), tuple(c // 2 for c in self.cols))

    def even(self) -> bool:
        return all(c % 2 == 0 for c in self.rows + self.cols)

    def __str__(self) -> str:
        return f"rows {'+'.join(map(str, self.rows))}, cols {'+'.join(map(str, self.cols))}"


def _moved(src, dst, j):
    """The (start, stop) intervals rank j holds under the counts `src` but
    not under `dst`: the parts of its source interval left and right of
    its destination interval."""
    a, b = _starts(src)[j], _starts(src)[j] + src[j]
    c, e = _starts(dst)[j], _starts(dst)[j] + dst[j]
    return (a, max(a, min(b, c))), (min(b, max(a, e)), b)


def _move(x, src, dst, dim, index, group):
    """This rank's (tile `index`) interval under the counts `dst` of a
    field held under the counts `src` along `dim`: each rank all-gathers
    what it gives away (its source interval outside its destination one,
    zero-padded to the widest), and keeps what falls in its destination."""
    n = len(src)
    width = max(sum(hi - lo for lo, hi in _moved(src, dst, j)) for j in range(n))
    a0 = _starts(src)[index]
    pieces = [x.narrow(dim, lo - a0, hi - lo) for lo, hi in _moved(src, dst, index) if hi > lo]
    used = sum(p.shape[dim] for p in pieces)
    if used < width:
        pad = list(x.shape)
        pad[dim] = width - used
        pieces.append(x.new_zeros(pad))
    parts = _all_gather(torch.cat(pieces, dim), group)
    c = _starts(dst)[index]
    e = c + dst[index]
    out = []
    for j, s0 in enumerate(_starts(src)):
        lo, hi = max(c, s0), min(e, s0 + src[j])
        if hi <= lo:
            continue
        if j == index:
            out.append(x.narrow(dim, lo - s0, hi - lo))
            continue
        left, right = _moved(src, dst, j)
        off = lo - left[0] if hi <= left[1] else (left[1] - left[0]) + lo - right[0]
        out.append(parts[j].to(x.device).narrow(dim, off, hi - lo))
    return torch.cat(out, dim)


class _Retile(torch.autograd.Function):
    """A field moved from the counts `src` to `dst` along `dim`; its
    adjoint is the move back, and its tangent moves with it."""

    @staticmethod
    def forward(x, src, dst, dim, index, group):
        return _move(x, src, dst, dim, index, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        src, dst, dim, index, group = ctx.args
        return _move(g, dst, src, dim, index, group), None, None, None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _move(t, *ctx.args)


def retile(x, src: tuple, dst: tuple, dim: int, index: int, group=None):
    """This rank's tile `x` (tile `index` along `dim` under the counts
    `src`, one per rank of the axis) moved to its tile under the counts
    `dst` of the same axis: the field, assembled, is the same bit for bit.
    Differentiable in both modes; the exchange runs over `group` (the
    axis's ranks in tile order; None: the world). x itself where the
    counts agree."""
    if tuple(src) == tuple(dst):
        return x
    if sum(src) != sum(dst) or len(src) != len(dst):
        raise ValueError(f"retile between {src} and {dst}: not two layouts of one axis")
    return _Retile.apply(x, tuple(src), tuple(dst), dim, index, group)


class _GatherWhole(torch.autograd.Function):
    """The whole (B, H, W, C) field on every rank of the tiling from each
    rank's tile under `layout`; the adjoint sums the ranks' gradients of
    the whole over the tiling's group and keeps this rank's tile, and the
    tangent is gathered as the value."""

    @staticmethod
    def forward(x, tiling, layout):
        return tiling._gather_whole(x, layout)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        tiling, layout = ctx.args
        rows, cols = layout.tile(tiling.s, tiling.w)
        g = all_sum(g.contiguous(), tiling.group)
        return g[:, rows, cols].contiguous(), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return ctx.args[0]._gather_whole(t, ctx.args[1])


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

    def layout(self, hw, window=None, what: str = "a level") -> Layout:
        """The tiling of a level's (H, W) grid on which its (wh, ww)
        windows (None: no windows) stay whole: the even tiles (`tile`)
        where they hold whole windows, else each axis's window rows or
        columns split as evenly as they go (`split`). Raises ValueError,
        naming `what`, the grid, the window and the mesh, where an axis has
        fewer windows than ranks or a window does not divide it."""
        if window is None:
            rows, cols = self.tile(hw, what)
            return Layout((rows.stop - rows.start,) * self.sh, (cols.stop - cols.start,) * self.sw)
        counts = []
        for n, size, win, dim, axis in ((self.sh, hw[0], window[0], "row", "sh"),
                                        (self.sw, hw[1], window[1], "column", "sw")):
            c = split(size, n, win)
            if c is None:
                k = size // win
                wins = (f"no whole {dim}s" if size % win
                        else f"{k} {dim}{'s' if k != 1 else ''}")
                raise ValueError(
                    f"{what}: its {hw[0]}x{hw[1]} grid has {wins} of {window[0]}x{window[1]} "
                    f"windows for the {n} ranks of the mesh axis {axis}={n} (mesh "
                    f"sh={self.sh}, sw={self.sw}); a window is never split between ranks")
            counts.append(c)
        return Layout(*counts)

    def retile(self, x, src: Layout, dst: Layout):
        """This rank's tile of a (B, H, W, C) field under `src` moved to its
        tile under `dst` (`retile` along each axis that differs)."""
        x = retile(x, src.rows, dst.rows, 1, self.s, self.lat_group)
        return retile(x, src.cols, dst.cols, 2, self.w, self.lon_group)

    def gather_whole(self, x, layout: Layout):
        """The whole (B, H, W, C) field, on every rank, of this rank's tile
        `x` under `layout`; differentiable in both modes (the backward sums
        every rank's gradient of the whole over the tiling's group)."""
        if self.sh * self.sw == 1:
            return x
        return _GatherWhole.apply(x, self, layout)

    def _gather_whole(self, x, layout):
        h, w = max(layout.rows), max(layout.cols)
        pad = x.new_zeros(x.shape[0], h, w, *x.shape[3:])
        pad[:, :x.shape[1], :x.shape[2]] = x
        parts = [p.to(x.device) for p in _all_gather(pad, self.group)]
        return torch.cat([torch.cat([parts[i * self.sw + j][:, :layout.rows[i], :layout.cols[j]]
                                     for j in range(self.sw)], 2) for i in range(self.sh)], 1)

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
