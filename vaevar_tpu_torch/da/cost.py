"""The vae4dvar and sc4dvar costs: 3D-Var and the 4D-Var window, reduced
and full-grid.

Port of vaevar_tpu/da/cost.py:

    vae4dvar: x0 = xb + up(decoder(z) * err_std * model_std)
    sc4dvar:  x0 = xb + up(B^1/2 w)  (da/cvt.py)
    J(x) = 1/2 ||x||^2 + obs_coeff * sum_t 1/2 sum H (M_t(x0) - yo_t)^2 / R_t

with M_t the hourly flow model applied t times inside the cost (t = 0 for
3D-Var). For nearest upsampling the analysis is constant per solver cell,
so the full-resolution obs term reduces exactly onto the solver grid once
per cycle: `reduce_obs` for da_win = 1, `reduce_obs_window` for windows,
where the rollout then runs natively on the solver grid through the static
gather S = down o up. The full-grid windowed cost (`make_vae4dvar_cost`,
`make_sc4dvar_cost`) is the reference the reduced form is held to, the
path of a window without a flow model, and the path of real observations:
there each slot's prediction is augmented to the 4 + 5 * dim_out
observation-level channels (ops/interp.augment_levels) before the
innovation (da_4dvar.py:1196-1206). Both modes share each form's code: only
the map from the control to the low-res increment differs.

With a `mesh` (parallel/mesh.py::SpatialMesh, run_da --mesh SHxSW or
TPxSHxSW) the full-resolution yo, H and a full R are this rank's tiles, and
xb stays whole. The reductions reduce each tile and sum the partial sums
over the mesh's spatial group (the tiles of one tp index), so the reduced
bundles, and the solves on them, need no collective of their own. The
full-grid costs evaluate the obs term on the tile: the obs branch starts at
`copy_to_ranks` and its Jo is summed over the spatial group by
`sum_over_tile_ranks`, so J, its gradient and its jvp slope are every tile's,
while Jb = 1/2 ||x||^2, outside the copy, counts once. The copy sits on the
low-res increment (69, h, w), the decoder's (or B^1/2's) output: the model's
backward then runs once, on the summed gradient, and rounds as it does in
one process (two partial gradients through a bf16 decoder would round
otherwise); the gradient crossing the ranks is (69, 128, 256) f32, 9 MB, at
the production solver grid. `mesh=None` is the single-device code.

The window costs' rollout (both forms) counts each step it asks for in
`window.rollout_steps` and runs each flow step through
dynamics.traced_step (`window.flow_forwards`, device span `window.step`),
inside the span `window.rollout` (utils/trace.py). A 3D-Var cost reaches
none of it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.da.dynamics import (
    checkpointed,
    make_integrate,
    rollout_window,
    traced_step,
)
from vaevar_tpu_torch.ops.interp import _nearest_idx, augment_levels, resize_nearest
from vaevar_tpu_torch.parallel.mesh import (
    copy_to_ranks,
    shard,
    sum_over_tile_ranks,
    sum_over_tiles,
    tile_for,
)
from vaevar_tpu_torch.utils import trace
from vaevar_tpu_torch.utils.capture import device_tables


class ObsBundle(NamedTuple):
    """Per-cycle data: background and observations."""

    xb: torch.Tensor  # (69, H, W)
    yo: torch.Tensor  # (T, C_obs, H, W): C_obs 69, or 4 + 5 * dim_out for real obs
    H: torch.Tensor  # (T, C_obs, H, W) 0/1 mask
    R: torch.Tensor  # (T, C_obs, 1, 1) obs error variance, or full (T, C_obs, H, W)


class ReducedObs(NamedTuple):
    """Obs term reduced onto the solver grid: per cell a = sum H/R,
    b = sum (H/R)(yo - xb); c = sum (H/R)(yo - xb)^2 over everything."""

    xb: torch.Tensor  # (69, H, W) full-resolution background
    a: torch.Tensor  # (69, h, w)
    b: torch.Tensor  # (69, h, w)
    c: torch.Tensor  # ()


class ReducedWindowObs(NamedTuple):
    """Window (da_win > 1) obs term reduced onto the solver grid, per slot in
    the cell-centred form

        Jo_t = 1/2 [sum a_t (p_t - ybar_t)^2 + c_t],
        a_t = sum_cell w_t, ybar_t = sum_cell (w_t tgt_t) / a_t,
        c_t = sum w_t (tgt_t - ybar_t)^2, w_t = H_t / R_t,

    with p_0 = e (the low-res increment, target yo_0 - xb) and p_t the coarse
    physical state of slot t (target yo_t). The naive a p^2 - 2 b p + c
    cancels ~4 f32 digits when p is a physical state (z500 ~ 5e4); p - ybar
    is innovation-sized."""

    xb: torch.Tensor  # (69, H, W) full-resolution background
    xb_low: torch.Tensor  # (69, h, w) nearest-sampled background
    a: torch.Tensor  # (T, 69, h, w)
    ybar: torch.Tensor  # (T, 69, h, w) weighted cell-mean target
    c: torch.Tensor  # (T,)


def _down_matrices(full_hw, low_hw, device, tile=None):
    """0/1 matrices (Hf, hl), (Wf, wl): Mh.T @ t @ Mw sums the full-resolution
    cells of each solver cell. With a `tile` (parallel/mesh.py::tile_for),
    only the tile's rows and columns: a tile's partial sums, which add up
    over the ranks to the whole (a solver cell may straddle two tiles)."""
    (Hf, Wf), (hl, wl) = full_hw, low_hw
    hi, wi = _nearest_idx(Hf, hl), _nearest_idx(Wf, wl)
    if tile is not None:
        hi, wi = hi[tile.rows], wi[tile.cols]
    Mh = np.eye(hl, dtype=np.float32)[hi]
    Mw = np.eye(wl, dtype=np.float32)[wi]
    return torch.as_tensor(Mh, device=device), torch.as_tensor(Mw, device=device)


def reduce_obs(bundle: ObsBundle, low_hw, mesh=None) -> ReducedObs:
    """Exact reduction of (yo, H, R) onto the solver grid (da_win == 1).
    With a `mesh`, of this rank's tiles, summed over its spatial group in
    one all-reduce: every rank returns the whole ReducedObs."""
    xb = bundle.xb
    tile = None if mesh is None else tile_for(mesh, xb.shape)
    Mh, Mw = _down_matrices(xb.shape[-2:], low_hw, xb.device, tile)
    w = bundle.H[0] / bundle.R[0]
    r = bundle.yo[0] - shard(xb, mesh)

    def down(t):
        return Mh.T @ (t @ Mw)

    a, b, c = down(w), down(w * r), torch.sum(w * r * r)
    if mesh is not None:
        a, b, c = sum_over_tiles(tile, a, b, c)
    return ReducedObs(xb=xb, a=a, b=b, c=c)


def reduce_obs_window(bundle: ObsBundle, low_hw, mesh=None) -> ReducedWindowObs:
    """Exact per-slot reduction of (yo, H, R) onto the solver grid (see
    ReducedWindowObs). One slot at a time, so the transients are (69, H, W)
    fields, not (T, 69, H, W) ones. With a `mesh`, of this rank's tiles:
    per slot a_t and the numerator of ybar_t are summed over the ranks
    before ybar_t is formed, then every slot's c_t, each rank's from its
    tile of up(ybar_t)."""
    xb = bundle.xb
    full_hw = tuple(xb.shape[-2:])
    tile = None if mesh is None else tile_for(mesh, xb.shape)
    Mh, Mw = _down_matrices(full_hw, low_hw, xb.device, tile)
    R = bundle.R.expand(bundle.H.shape[0], *bundle.R.shape[1:])
    a, ybar, c = [], [], []
    for t in range(bundle.H.shape[0]):
        w = bundle.H[t] / R[t]
        tgt = bundle.yo[t] - shard(xb, mesh) if t == 0 else bundle.yo[t]
        a_t = Mh.T @ (w @ Mw)
        num_t = Mh.T @ ((w * tgt) @ Mw)
        if mesh is not None:
            a_t, num_t = sum_over_tiles(tile, a_t, num_t)
        pos = a_t > 0
        yb_t = torch.where(pos, num_t / torch.where(pos, a_t, 1.0), 0.0)
        dev = tgt - resize_nearest(yb_t, full_hw, tile)
        a.append(a_t)
        ybar.append(yb_t)
        c.append(torch.sum(w * dev * dev))
    c = torch.stack(c)
    if mesh is not None:
        (c,) = sum_over_tiles(tile, c)
    return ReducedWindowObs(xb=xb, xb_low=resize_nearest(xb, low_hw), a=torch.stack(a),
                            ybar=torch.stack(ybar), c=c)


def _resample_gather(n_full: int, n_low: int) -> np.ndarray:
    """Index table of S = down o up on one axis (see ReducedWindowObs)."""
    down = _nearest_idx(n_low, n_full)  # coarse j -> fine row
    up = _nearest_idx(n_full, n_low)  # fine f -> coarse cell
    return up[down]


def _make_window_obs_reduced(increment: Callable, flow, da_win: int,
                             step_checkpoint: bool = True):
    """Jo over the window from a ReducedWindowObs: the hourly rollout runs
    natively on the solver grid (the full path's per-step resizes collapse to
    the static gather S), with one checkpoint per step when
    `step_checkpoint`."""
    if da_win > 1 and flow is None:
        raise ValueError(
            "reduced window cost requires a flow model for da_win > 1 "
            "(the persistence fallback scores xb + up(e) against every slot, "
            "which only reduces in innovation form: use the full windowed cost)")

    def quad(a_t, ybar_t, c_t, p):
        d = p - ybar_t
        return 0.5 * (torch.sum(a_t * d * d) + c_t)

    if da_win > 1:
        integrate = make_integrate(flow)
        step = traced_step(lambda s: integrate(s, 1))
        if step_checkpoint:
            step = checkpointed(step)
    @device_tables
    def gather(device, full_hw, low_hw):
        """S's index tables on the device, or None where S is the identity."""
        (Hf, Wf), (hl, wl) = full_hw, low_hw
        gh, gw = _resample_gather(Hf, hl), _resample_gather(Wf, wl)
        if np.array_equal(gh, np.arange(hl)) and np.array_equal(gw, np.arange(wl)):
            return None
        return torch.as_tensor(gh, device=device), torch.as_tensor(gw, device=device)

    def window_obs(z, bundle: ReducedWindowObs):
        e = increment(z)  # (69, h, w) physical increment
        jo = quad(bundle.a[0], bundle.ybar[0], bundle.c[0], e)
        if da_win == 1:
            return jo
        tables = gather(e.device, tuple(bundle.xb.shape[-2:]), tuple(e.shape[-2:]))
        if tables is None:
            def S(v):
                return v
        else:
            gh_t, gw_t = tables

            def S(v):
                return v.index_select(-2, gh_t).index_select(-1, gw_t)

        nxt = bundle.xb_low + S(e)  # down(xb + up(e)), exactly
        with trace.span("window.rollout"):
            for t in range(1, da_win):
                trace.count("window.rollout_steps")
                m = step(nxt)
                jo = jo + quad(bundle.a[t], bundle.ybar[t], bundle.c[t], m)
                nxt = S(m)
        return jo

    return window_obs


def _increment_fn(decoder, err_std=None):
    """z -> the decoder's physical low-res increment (69, h, w) in f32, the
    decoder's output scaled by err_std (default channels.ERR_STD, the
    reference's stdTr table) and the model std."""
    err_std = channels.ERR_STD if err_std is None else np.asarray(err_std)

    @device_tables
    def scales(device):
        return tuple(torch.as_tensor(t, dtype=torch.float32, device=device).reshape(-1, 1, 1)
                     for t in (err_std, channels.STD))

    def increment(z):
        err, mstd = scales(z.device)
        return decoder(z)[0].float() * err * mstd

    return increment


def _state_fn(increment):
    """(z, bundle, tile=None) -> xb + up(increment(z)): the state on xb's
    grid, or with a `tile` of that grid (parallel/mesh.py::tile_for) the
    tile of it alone, bit for bit."""

    def to_state(z, bundle, tile=None):
        xb = bundle.xb if tile is None else bundle.xb[..., tile.rows, tile.cols]
        return xb + resize_nearest(increment(z), bundle.xb.shape[-2:], tile)

    return to_state


def _window_reduced_cost(increment, flow, da_win, obs_coeff, step_checkpoint):
    """(cost, to_state, cost_parts) on a ReducedWindowObs for x -> the
    low-res physical increment `increment(x)`."""
    window_obs = _make_window_obs_reduced(increment, flow, da_win, step_checkpoint)

    def cost(x, bundle: ReducedWindowObs):
        return 0.5 * torch.sum(x ** 2) + obs_coeff * window_obs(x, bundle)

    def cost_parts(x, bundle: ReducedWindowObs):
        """(Jb, Jo) with Jo unscaled by obs_coeff, like the reference printout."""
        return 0.5 * torch.sum(x ** 2), window_obs(x, bundle)

    return cost, _state_fn(increment), cost_parts


def make_vae4dvar_cost_window_reduced(decoder, flow=None, da_win: int = 1,
                                      obs_coeff: float = 1.0, err_std=None,
                                      step_checkpoint: bool = True):
    """(cost, to_state, cost_parts) of the 4D-Var vae4dvar cost on a
    ReducedWindowObs: the same J as make_vae4dvar_cost up to float
    associativity, with no full-resolution tensor inside the solve."""
    return _window_reduced_cost(_increment_fn(decoder, err_std), flow, da_win, obs_coeff,
                                step_checkpoint)


def make_sc4dvar_cost_window_reduced(increment: Callable, flow=None, da_win: int = 1,
                                     obs_coeff: float = 1.0, step_checkpoint: bool = True):
    """The 4D-Var sc4dvar cost on a ReducedWindowObs: the CVT increment is
    nearest-upsampled (da_4dvar.py:928), so the vae4dvar reduction applies.
    `increment(w)` is B^1/2 w on the solver grid (cvt.CVTransform.increment)."""
    return _window_reduced_cost(increment, flow, da_win, obs_coeff, step_checkpoint)


def obs_term(x_pred, bundle: ObsBundle, interp_matrix=None, mesh=None):
    """1/2 sum H (x_pred - yo)^2 / R, with x_pred first augmented to the
    observation levels when `interp_matrix` is given. With a `mesh`, x_pred
    and the bundle's obs fields are this rank's tiles, and the sum runs
    over every rank's tile (`sum_over_tile_ranks`)."""
    if interp_matrix is not None:
        x_pred = augment_levels(x_pred, interp_matrix)
    jo = 0.5 * torch.sum(bundle.H * (x_pred - bundle.yo) ** 2 / bundle.R)
    return jo if mesh is None else sum_over_tile_ranks(jo, tile_for(mesh, bundle.xb.shape))


def _window_predict(x0, flow, flow_hw, da_win: int):
    """States of every slot, (da_win, 69, H, W): the flow model rolled out
    with nearest resizes to and from `flow_hw`."""
    if da_win == 1 or flow is None:
        return x0[None]
    integrate = make_integrate(flow, flow_hw)
    return rollout_window(x0, lambda x: integrate(x, 1, interpolation=True), da_win)


def _make_window_obs(flow, flow_hw, da_win: int, interp_matrix=None, mesh=None):
    """Jo accumulated inside the rollout, one checkpoint per step, so the
    live set is one slot (the reference's folded form). With real obs
    (`interp_matrix`) each slot's prediction is augmented to the observation
    levels inside the step, so the backward recomputes the augmentation
    with the flow step (da_4dvar.py:1196-1206). With a `mesh` the bundle's
    obs fields are tiles, and so is x0 without a rollout: with one, the
    rollout runs on whole states and each slot reads the tile of its state.
    The window's Jo is summed over the ranks."""
    rollout = da_win > 1 and flow is not None

    def jo_slot(x, yo_t, h_t, r_t):
        p = (shard(x, mesh) if rollout else x)[None]
        if interp_matrix is not None:
            p = augment_levels(p, interp_matrix)
        return 0.5 * torch.sum(h_t * (p[0] - yo_t) ** 2 / r_t)

    if rollout:
        integrate = make_integrate(flow, flow_hw)
        flow_step = traced_step(lambda x: integrate(x, 1, interpolation=True))

        @checkpointed
        def step(x, yo_t, h_t, r_t):
            x = flow_step(x)
            return x, jo_slot(x, yo_t, h_t, r_t)

    def window_obs(x0, bundle: ObsBundle):
        if flow is None and da_win > 1:
            # persistence: x0 scored against every slot
            return obs_term(x0[None], bundle, interp_matrix, mesh)
        R = bundle.R.expand(bundle.yo.shape[0], *bundle.R.shape[1:])
        jo = jo_slot(x0, bundle.yo[0], bundle.H[0], R[0])
        if rollout:
            x = x0
            with trace.span("window.rollout"):
                for t in range(1, da_win):
                    trace.count("window.rollout_steps")
                    x, jo_t = step(x, bundle.yo[t], bundle.H[t], R[t])
                    jo = jo + jo_t
        return jo if mesh is None else sum_over_tile_ranks(jo, tile_for(mesh, bundle.xb.shape))

    return window_obs


def _full_cost(increment, flow, flow_hw, da_win, obs_coeff, interp_matrix=None, mesh=None):
    """(cost, to_state, cost_parts) on a full-resolution ObsBundle for x ->
    the low-res physical increment `increment(x)`, to_state(x, bundle) the
    state on xb's grid. With a `mesh`, the obs branch starts at
    copy_to_ranks(increment(x)), and without a rollout it reads the tile of
    the state alone."""
    to_state = _state_fn(increment)
    window_obs = _make_window_obs(flow, flow_hw, da_win, interp_matrix, mesh)
    if mesh is None:
        obs_state = to_state
    else:
        branch = _state_fn(lambda x: copy_to_ranks(increment(x), mesh.group))
        rollout = da_win > 1 and flow is not None  # the rollout runs on whole states

        def obs_state(x, bundle: ObsBundle):
            return branch(x, bundle, None if rollout else tile_for(mesh, bundle.xb.shape))

    def cost(x, bundle: ObsBundle):
        return 0.5 * torch.sum(x ** 2) + obs_coeff * window_obs(obs_state(x, bundle), bundle)

    def cost_parts(x, bundle: ObsBundle):
        return 0.5 * torch.sum(x ** 2), window_obs(obs_state(x, bundle), bundle)

    return cost, to_state, cost_parts


def make_vae4dvar_cost(decoder, flow=None, flow_hw=(128, 256), da_win: int = 1,
                       obs_coeff: float = 1.0, interp_matrix=None, err_std=None, mesh=None):
    """(cost, decode_to_state, cost_parts) on a full-resolution ObsBundle.

    decoder(z) -> (1, 69, h', w') is nearest-upsampled to xb's grid, scaled
    by err_std * model_std and added to xb (da_4dvar.py:1185-1188). With
    `interp_matrix` (dim_out, 13) the obs are real obs on the 4 + 5 * dim_out
    augmented channels: the only form for them, as QC'd level-augmented
    innovations do not reduce onto the solver grid. `mesh`: see the module
    docstring."""
    return _full_cost(_increment_fn(decoder, err_std), flow, flow_hw, da_win, obs_coeff,
                      interp_matrix, mesh)


def make_sc4dvar_cost(transform, flow=None, flow_hw=(128, 256), da_win: int = 1,
                      obs_coeff: float = 1.0, interp_matrix=None, mesh=None):
    """(cost, to_state, cost_parts) on a full-resolution ObsBundle, with the
    state xb + up(B^1/2 w) of `transform` (a cvt.CVTransform, whose
    `increment` is B^1/2 w on the solver grid); the form of a window
    without a flow model and of real obs (`interp_matrix`)."""
    return _full_cost(transform.increment, flow, flow_hw, da_win, obs_coeff, interp_matrix,
                      mesh)


def _reduced_cost(increment, obs_coeff):
    """(cost, to_state, cost_parts) on a ReducedObs for x -> the low-res
    physical increment `increment(x)`."""

    def obs_quad(e, bundle: ReducedObs):
        return 0.5 * (torch.sum(bundle.a * e * e) - 2.0 * torch.sum(bundle.b * e)
                      + bundle.c)

    def cost(x, bundle: ReducedObs):
        return 0.5 * torch.sum(x ** 2) + obs_coeff * obs_quad(increment(x), bundle)

    def cost_parts(x, bundle: ReducedObs):
        """(Jb, Jo) with Jo unscaled by obs_coeff, like the reference printout."""
        return 0.5 * torch.sum(x ** 2), obs_quad(increment(x), bundle)

    return cost, _state_fn(increment), cost_parts


def make_vae4dvar_cost_reduced(decoder, obs_coeff: float = 1.0, err_std=None):
    """(cost, decode_to_state, cost_parts) on a ReducedObs bundle.

    `decoder` maps z (1, C_lat, h, w) to the normalised increment
    (1, 69, h, w); `err_std` (69,) scales it (default channels.ERR_STD)."""
    return _reduced_cost(_increment_fn(decoder, err_std), obs_coeff)


def make_sc4dvar_cost_reduced(increment: Callable, obs_coeff: float = 1.0):
    """3D-Var sc4dvar cost on a ReducedObs bundle: the CVT output is
    nearest-upsampled (da_4dvar.py:928), so the vae4dvar reduction applies.
    `increment(w)` is B^1/2 w on the solver grid (cvt.CVTransform.increment)."""
    return _reduced_cost(increment, obs_coeff)
