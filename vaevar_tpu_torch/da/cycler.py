"""Cycled data assimilation loop: background -> analysis -> 6 h forecast.

Port of vaevar_tpu/da/cycler.py: spin-up (`get_initial_state`, init_tp 0,
1 or 2), per-cycle truth frames at 1 h steps over the window, and the
observations of the obs type:
- synthetic masks (free_, column_random_, mask files in `mask_dir`) drawn
  from one seeded generator in cycle order, obs = truth at mask points;
- prepbufr*: the 69-channel mask gridded from station reports, obs = truth;
- real*: station reports (or `obs_from_numpy` arrays) gridded onto the
  4 + 5 * interp_dim observation-level channels, the truth augmented to
  them on the device, QC'd against it, and for real_simu* replaced by it;
  R augmented likewise.
R carries the model error Q for the window's later slots. The analysis comes
from the solve through the VAE decoder (vae4dvar) or the control-variable
transform B^1/2 (sc4dvar, `cvt`), in 3D-Var or in 4D-Var with the hourly
flow model inside J (reduced onto the solver grid, or the full-grid cost for
real obs), or from a baseline (free_run: the background; interpolation:
griddata on the host). Then the forecast advance, per-cycle metrics appended
to `metrics_log.jsonl` and consolidated into `<metric>.npy` dumps, with
`use_eval` the obs-space error on held-out cells (`error_obs`), optional
field dumps and a multi-step forecast score, and a restartable on-disk state
(`xb.npy` + `current_time.txt`). With `prefetch_obs` (the default) the next
cycle's obs are prepared on one worker thread under the current solve, on a
CUDA stream of its own; it changes no number. The forecast model runs under
torch.no_grad(): no cost differentiates through the advance.

With a `mesh` (parallel/mesh.py::SpatialMesh, run_da --mesh SHxSW) each rank
prepares and holds only its tile of the full-resolution obs fields (yo, H,
the eval mask; the prefetch worker too, which runs no collective), while
the models, the states, the truth and the analysis are whole on every rank;
the reductions, the costs and the obs-space error sum over the mesh's
spatial group, so every rank computes the same cycle. Under --mesh
TPxSHxSW the models' LG stages are split over each tile's tp group, and
their sums there keep the ranks equal too. Rank 0 alone writes the work
dir; each cycle every rank of the world compares digests of the control
and the analysis, and of the state it starts from, and raises on a
mismatch.
"""

from __future__ import annotations

import functools
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Callable

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.config import DAConfig
from vaevar_tpu_torch.da import baselines
from vaevar_tpu_torch.da import cost as cost_mod
from vaevar_tpu_torch.da import obs as obs_mod
from vaevar_tpu_torch.da.solver import SolveDiagnostics, VariationalSolver
from vaevar_tpu_torch.ops.interp import augment_levels, obs_level_interp_matrix
from vaevar_tpu_torch.parallel import mesh as pmesh
from vaevar_tpu_torch.utils import metrics as M

CYCLE = timedelta(hours=6)
STEP = timedelta(hours=1)

_METRIC_KEYS = (
    "bg_wrmse", "ana_wrmse", "bg_mse", "ana_mse", "bg_bias", "ana_bias",
    "error_obs",
)


@torch.no_grad()
def score(x, gt0):
    """Physical-unit WRMSE (69,), bias (69,) and normalised MSE of a field
    against truth (da_4dvar.py:946-957 semantics)."""
    mean = torch.as_tensor(channels.MEAN, dtype=torch.float32,
                           device=x.device).reshape(-1, 1, 1)
    std = torch.as_tensor(channels.STD, dtype=torch.float32, device=x.device)
    xn = (x - mean) / std.reshape(-1, 1, 1)
    gn = (gt0 - mean) / std.reshape(-1, 1, 1)
    wrmse = M.weighted_rmse(xn[None], gn[None]) * std
    bias = M.weighted_bias((xn - gn)[None]) * std
    mse = torch.mean((xn - gn) ** 2)
    return wrmse.cpu().numpy(), bias.cpu().numpy(), float(mse)


def check_device(device) -> str:
    """`device` as a string, after checking that it exists: a CUDA device
    without one raises instead of falling back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return str(device)


def parse_time(ts) -> datetime:
    return ts if isinstance(ts, datetime) else datetime.fromisoformat(str(ts))


@dataclass
class CycledDA:
    cfg: DAConfig
    state_source: object  # .get_state(datetime) -> (69, H, W) physical
    forecast_integrate: Callable  # integrate(x, steps, interpolation)
    decoder: torch.nn.Module | None = None  # vae4dvar: latent -> (1, 69, h, w)
    flow: torch.nn.Module | None = None  # hourly model for 4D-Var windows
    cvt: object = None  # sc4dvar: cvt.CVTransform, B^1/2 with .increment
    coeff_dir: str | None = None  # Q-matrix asset dir (q_type 0 and 1)
    err_std: np.ndarray | None = None  # per-channel decoder scaling for
    # vae4dvar (None => channels.ERR_STD, the reference stdTr table; an OSSE
    # passes the empirical error std its VAE was trained on)
    work_dir: str = "da_cycle_results/run"
    seed: int = 0
    device: str = "cuda"  # the card, as JAX's cycler takes the default
    # accelerator; "cpu" must be asked for
    verbose: bool = True
    reports_source: object = None  # .get_reports(datetime): station reports
    # (data/reports.py) for the real* and prepbufr* obs types
    mask_dir: str | None = None  # mask_<obs_type>.npy files
    mask_eval: np.ndarray | None = None  # obs-space holdout (C_obs, H, W);
    # with use_eval and none given, a synthetic 20 % holdout from seed + 7
    save_field: bool = False  # dump xb/xa per cycle (da_4dvar.py:713-716)
    save_gt: bool = False  # dump the truth per cycle (da_4dvar.py:717-719)
    save_obs: bool = False  # dump the obs per cycle (da_4dvar.py:720-722)
    forecast_eval: bool = False  # per-cycle forecast WRMSE from the analysis
    forecast_eval_steps: int = 20  # leads of 6 h (20 = 5 days)
    obs_from_numpy: str | None = None  # pre-gridded obs dir
    # (obs.load_numpy_obs) in place of station gridding, real obs only
    prefetch_obs: bool = True  # prepare the next cycle's obs on one worker
    # thread under the current solve (on a CUDA device on its own stream);
    # one worker keeps the synthetic masks' draws in cycle order, so the
    # numbers are those of the serial loop (prefetch_obs=False)
    mesh: object = None  # parallel/mesh.SpatialMesh of a sharded solve: the
    # obs fields tiled over its ranks, everything else whole on each (or
    # the models' LG stages split over a tp group)
    metrics_list: dict = field(default_factory=lambda: {k: [] for k in _METRIC_KEYS})

    def __post_init__(self):
        self.device = check_device(self.device)
        cfg = self.cfg
        if cfg.da_mode not in ("free_run", "interpolation", "vae4dvar", "sc4dvar"):
            raise NotImplementedError(f"da_mode {cfg.da_mode!r}")
        if cfg.da_mode in ("vae4dvar", "sc4dvar"):
            role = "decoder" if cfg.da_mode == "vae4dvar" else "cvt"
            if getattr(self, role) is None:
                raise ValueError(f"da_mode {cfg.da_mode!r} needs a {role}")
        self.is_real_obs = cfg.obs_type.startswith("real")
        # station families fail at construction, not at the first cycle
        if cfg.obs_type.startswith("prepbufr"):
            if cfg.da_win not in (1, 6):
                raise NotImplementedError("prepbufr obs: da_win must be 1 or 6 "
                                          "(da_4dvar.py:192)")
            if self.reports_source is None:
                raise ValueError("obs_type=prepbufr* needs a reports_source "
                                 "(LocalReportsStore/SyntheticReports)")
        if self.is_real_obs and self.reports_source is None and not self.obs_from_numpy:
            raise ValueError("obs_type=real* needs a reports_source or obs_from_numpy")
        self._writes = self.mesh is None or self.mesh.rank == 0
        if self._writes:
            os.makedirs(self.work_dir, exist_ok=True)
        self._rng = np.random.default_rng(self.seed)
        q = obs_mod.load_q_matrix(self.coeff_dir or self.mask_dir or ".", cfg.q_type,
                                  cfg.da_win) if cfg.da_win > 1 else None
        self.R = obs_mod.build_R(
            obs_mod.obs_error_variance(cfg.obs_std, cfg.modify_tp), q, cfg.da_win)
        self._interp = None
        if self.is_real_obs:
            self._interp = obs_level_interp_matrix(cfg.interp_dim)
            # R on the observation levels (da_4dvar.py:744-756)
            self.R_aug = augment_levels(torch.as_tensor(self.R), self._interp).numpy()
            self._std_aug = obs_mod.std_layer_augmented(cfg.interp_dim)
        if cfg.use_eval and self.mask_eval is None:
            # stand-in for the reference's dataset/mask_eval1.npy (not in its
            # repo): hold out ~20 % of the obs cells for validation
            c_obs = 4 + 5 * cfg.interp_dim if self.is_real_obs else channels.N_CHANNELS
            self.mask_eval = (np.random.default_rng(self.seed + 7)
                              .random((c_obs, *cfg.grid_hw)) < 0.2).astype(np.float32)
        self._mask_eval_t = None  # its device copy, made at first use
        if self.forecast_eval:
            self.metrics_list["forecast_wrmse"] = []
        self._load_metrics()
        for model in (self.decoder, self.flow):
            if model is not None:
                model.requires_grad_(False)
        # the cycle log's bytes of the cost's models on this rank (a
        # tensor-parallel rank holds its slices)
        self.param_bytes = sum(p.numel() * p.element_size() for m in (self.decoder, self.flow)
                               if m is not None for p in m.parameters())
        self._solver = self._build_solver()
        # the prefetch worker's stream: its copies, augmentation and QC run
        # beside the solve on the loop's stream
        self._obs_stream = (torch.cuda.Stream(device=self.device)
                            if self.prefetch_obs and torch.device(self.device).type == "cuda"
                            else None)
        # per-run record: spin-up seconds and, per cycle, seconds and the
        # solver's (Jb, Jo) trace; last_obs_info is the obs record of the
        # last cycle the loop took
        self.timings = {"spin_up_s": None, "cycle_s": []}
        self.cycle_log: list[dict] = []
        self.lockstep_digests: list[str] = []  # under a mesh, each one checked
        self.last_obs_info: dict = {}

    @property
    def _reducible(self):
        """Per-channel obs with a nearest upsample: the obs term reduces
        exactly onto the solver grid (cost.ReducedObs for 3D-Var,
        cost.ReducedWindowObs for windows). Real obs (level-augmented
        innovations and QC masks) and a window without a flow model keep the
        full windowed form."""
        if self._interp is not None:
            return False
        return not (self.cfg.da_win > 1 and self.flow is None)

    @property
    def _use_reduced_obs(self):
        return self._reducible and self.cfg.da_win == 1

    def _build_solver(self):
        """The cost of the configuration (vaevar_tpu/da/cycler.py:182-257):
        the reduced 3D-Var cost, the reduced window cost or the full windowed
        cost of the mode, with the obs reduction it takes
        (`self._reduce_obs`). sc4dvar runs at most 5 L-BFGS iterations per
        segment (da_4dvar.py:1119), with the eval budget derived from them.
        free_run and interpolation solve nothing (None)."""
        cfg = self.cfg
        self._reduce_obs = None
        if cfg.da_mode not in ("vae4dvar", "sc4dvar"):
            return None
        sc = cfg.da_mode == "sc4dvar"
        if self._use_reduced_obs:
            c, to_state, parts = (
                cost_mod.make_sc4dvar_cost_reduced(self.cvt.increment, cfg.obs_coeff) if sc
                else cost_mod.make_vae4dvar_cost_reduced(self.decoder, cfg.obs_coeff,
                                                         err_std=self.err_std))
            self._reduce_obs = functools.partial(cost_mod.reduce_obs, mesh=self.mesh)
        elif self._reducible:  # da_win > 1
            make = (cost_mod.make_sc4dvar_cost_window_reduced if sc else functools.partial(
                cost_mod.make_vae4dvar_cost_window_reduced, err_std=self.err_std))
            c, to_state, parts = make(
                self.cvt.increment if sc else self.decoder, self.flow, da_win=cfg.da_win,
                obs_coeff=cfg.obs_coeff, step_checkpoint=cfg.window_step_checkpoint)
            self._reduce_obs = functools.partial(cost_mod.reduce_obs_window, mesh=self.mesh)
        else:
            make = cost_mod.make_sc4dvar_cost if sc else functools.partial(
                cost_mod.make_vae4dvar_cost, err_std=self.err_std)
            c, to_state, parts = make(
                self.cvt if sc else self.decoder, self.flow, flow_hw=cfg.solver_hw,
                da_win=cfg.da_win, obs_coeff=cfg.obs_coeff, interp_matrix=self._interp,
                mesh=self.mesh)
        return VariationalSolver(
            c, to_state, parts, lbfgs_iters=min(cfg.lbfgs_iters, 5) if sc else cfg.lbfgs_iters,
            history=cfg.lbfgs_history, max_segment_evals=cfg.lbfgs_max_evals,
            linesearch=cfg.lbfgs_linesearch)

    @property
    def _tile(self):
        """This rank's tile of every full field on the grid (yo, H, a full R,
        the eval mask), under a mesh: the cycler tiles them, and the solver
        takes them as they are."""
        return None if self.mesh is None else pmesh.tile_for(self.mesh, self.cfg.grid_hw)

    def _dev(self, a, tile: bool = False):
        """a as an f32 tensor on the device; with `tile`, only this rank's
        tile of a full field on the grid crosses to the device (a
        broadcastable a whole)."""
        if tile:
            a = pmesh.shard(np.asarray(a), self.mesh)
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)

    def _host(self, x):
        """This rank's tile of a grid field, whole on the host (all-gathered:
        every rank calls this)."""
        return pmesh.host_value(x, self.mesh, self.cfg.grid_hw)

    def _check_lockstep(self, *xs):
        """Under a mesh, every rank's digest of xs must be rank 0's, or this
        raises: the ranks compute the same cycle bit for bit."""
        if self.mesh is not None:
            self.lockstep_digests.append(pmesh.check_replicas(pmesh.digest(*xs)))

    def _sync(self):
        """Wait for the work queued on this thread's current stream: the
        loop's stream on the loop's thread, the obs stream on the prefetch
        worker, which so never waits for the solve."""
        if self.device.startswith("cuda"):
            torch.cuda.current_stream(self.device).synchronize()

    # --- resume machinery -------------------------------------------------

    def _load_metrics(self):
        for k in self.metrics_list:
            p = os.path.join(self.work_dir, f"{k}.npy")
            if os.path.exists(p):
                self.metrics_list[k] = list(np.load(p, allow_pickle=True))
        # replay entries newer than the last consolidated snapshot
        log = os.path.join(self.work_dir, "metrics_log.jsonl")
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    if not line.strip():
                        continue
                    e = json.loads(line)
                    lst = self.metrics_list.get(e["k"])
                    if lst is not None and e["i"] == len(lst):
                        v = e["v"]
                        lst.append(np.asarray(v) if isinstance(v, list) else v)
        self._flushed = {k: len(v) for k, v in self.metrics_list.items()}

    def save_eval_result(self, consolidate: bool = False):
        """Append new metric entries to metrics_log.jsonl; with
        `consolidate`, write the reference-format .npy dumps and truncate
        the log (rank 0 alone under a mesh)."""
        new = []
        for k, v in self.metrics_list.items():
            for i in range(self._flushed.get(k, 0), len(v)):
                val = v[i]
                new.append({"k": k, "i": i,
                            "v": val.tolist() if hasattr(val, "tolist") else val})
            self._flushed[k] = len(v)
        if not self._writes:
            return
        if new:
            with open(os.path.join(self.work_dir, "metrics_log.jsonl"), "a") as f:
                for e in new:
                    f.write(json.dumps(e) + "\n")
        if not consolidate:
            return
        for k, v in self.metrics_list.items():
            try:
                arr = np.asarray(v)
            except ValueError:  # ragged (a forecast_eval row cut by the truth's end)
                arr = np.array(v, dtype=object)
            np.save(os.path.join(self.work_dir, k), arr)
        open(os.path.join(self.work_dir, "metrics_log.jsonl"), "w").close()

    def save_ckpt(self, current_time, xb):
        if not self._writes:
            return
        np.save(os.path.join(self.work_dir, "xb.npy"), xb.detach().cpu().numpy())
        with open(os.path.join(self.work_dir, "current_time.txt"), "w") as f:
            f.write(str(current_time))

    def get_current_states(self, start_time):
        tpath = os.path.join(self.work_dir, "current_time.txt")
        xpath = os.path.join(self.work_dir, "xb.npy")
        current = start_time
        if os.path.exists(tpath):
            with open(tpath) as f:
                current = parse_time(f.read().strip())
        if os.path.exists(xpath):
            return current, self._dev(np.load(xpath))
        t0 = time.perf_counter()
        xb = self.get_initial_state(start_time)
        self._sync()
        self.timings["spin_up_s"] = time.perf_counter() - t0
        if self.verbose:
            print(f"spin-up took {self.timings['spin_up_s']:.2f}s", flush=True)
        return current, xb

    @torch.no_grad()
    def get_initial_state(self, start_time):
        """Spin-up per init_tp (da_4dvar.py:649-664): 0 integrates the
        forecast model init_lag steps from the truth init_lag cycles before
        the start, 1 takes that truth, any other value the truth of 4 x 183
        cycles (183 days) before the start."""
        cfg = self.cfg
        if cfg.init_tp not in (0, 1):
            return self._dev(self.state_source.get_state(start_time - 4 * 183 * CYCLE))
        x0 = self._dev(self.state_source.get_state(start_time - cfg.init_lag * CYCLE))
        if cfg.init_tp == 0:
            return self.forecast_integrate(x0, cfg.init_lag, True)
        return x0

    @torch.no_grad()
    def advance(self, xa):
        return self.forecast_integrate(xa, 1, True)

    # --- per-cycle pieces -------------------------------------------------

    def get_obs_info(self, current_time, info: dict | None = None):
        """(yo, H, R, gt) on the device, one truth frame per hourly slot of
        the window. Synthetic families and prepbufr*: noiseless obs = truth
        at the mask points (da_4dvar.py:449), 69 channels. real*: station
        reports gridded onto the augmented obs-level channels
        (da_4dvar.py:758-805), with a second report file for windows longer
        than 3 h; the truth is augmented on the device, the obs QC'd against
        it, and real_simu* replace the obs values by it. For the station
        families the phase seconds and obs counts go into `info`, when
        given. Device work goes on the current stream."""
        cfg = self.cfg
        info = {} if info is None else info
        t0 = time.perf_counter()
        gt = np.stack([self.state_source.get_state(current_time + t * STEP)
                       for t in range(cfg.da_win)])  # (T, 69, H, W)
        if self.is_real_obs:
            t1 = time.perf_counter()
            if self.obs_from_numpy:
                yo, H = obs_mod.load_numpy_obs(self.obs_from_numpy, current_time, cfg.da_win)
            else:
                reports = [self.reports_source.get_reports(current_time)]
                if cfg.da_win > 3:
                    reports.append(self.reports_source.get_reports(current_time + CYCLE))
                yo, H = obs_mod.grid_real_obs(reports, cfg.da_win, cfg.interp_dim, cfg.grid_hw)
            t2 = time.perf_counter()
            gt_d, yo, H = self._dev(gt), self._dev(yo, tile=True), self._dev(H, tile=True)
            del gt
            n_gridded = float(H.sum())
            gt_aug = augment_levels(pmesh.shard(gt_d, self.mesh), self._interp)
            H = obs_mod.qc_filter(yo, gt_aug, H, cfg.filter_coeff, cfg.obs_type,
                                  self._std_aug)
            if cfg.obs_type.startswith("real_simuz"):
                yo[:, 4:44] = gt_aug[:, 4:44] * H[:, 4:44]
            elif cfg.obs_type.startswith("real_simu"):
                yo = gt_aug * H
            del gt_aug
            n_kept = float(H.sum())
            self._sync()
            info.update(truth_s=t1 - t0, grid_s=t2 - t1, aug_qc_s=time.perf_counter() - t2,
                        n_gridded=n_gridded, n_kept=n_kept)
            return yo, H, self._dev(self.R_aug, tile=True), gt_d
        if cfg.obs_type.startswith("prepbufr"):
            # station-report mask family (da_4dvar.py:190-274): da_win 1 or 6
            t1 = time.perf_counter()
            H = obs_mod.station_mask_from_reports(
                self.reports_source.get_reports(current_time), cfg.da_win, cfg.grid_hw)
            if cfg.da_win > 3:
                H = obs_mod.station_mask_from_reports(
                    self.reports_source.get_reports(current_time + CYCLE), cfg.da_win,
                    cfg.grid_hw, second_file=True, H_out=H)
            info.update(truth_s=t1 - t0, grid_s=time.perf_counter() - t1,
                        n_gridded=float(H.sum()))
        else:
            H = obs_mod.make_obs_mask(cfg.obs_type, cfg.da_win, cfg.grid_hw, self._rng,
                                      self.mask_dir)
        gt_d = self._dev(gt)
        return (pmesh.shard(gt_d, self.mesh), self._dev(H, tile=True),
                self._dev(self.R, tile=True), gt_d)

    def _score(self, prefix, x, gt0):
        wrmse, bias, mse = score(x, gt0)
        self.metrics_list[f"{prefix}_wrmse"].append(wrmse)
        self.metrics_list[f"{prefix}_bias"].append(bias)
        self.metrics_list[f"{prefix}_mse"].append(mse)
        return wrmse

    def _mask_eval_dev(self):
        if self._mask_eval_t is None:
            self._mask_eval_t = self._dev(self.mask_eval, tile=True)
        return self._mask_eval_t

    @torch.no_grad()
    def _obs_holdout_error(self, xa, yo0, H_old0):
        """Obs-space RMSE per channel on the held-out cells
        (da_4dvar.py:1285-1287), the analysis augmented for real obs. Under
        a mesh, on this rank's tile, the numerator and the denominator
        summed over the ranks."""
        xa = pmesh.shard(xa, self.mesh)
        xhat = augment_levels(xa[None], self._interp)[0] if self.is_real_obs else xa
        w = self._mask_eval_dev() * H_old0
        num = torch.sum((xhat - yo0) ** 2 * w, dim=(1, 2))
        den = torch.sum(w, dim=(1, 2))
        if self.mesh is not None:
            num, den = pmesh.sum_over_tiles(self._tile, num, den)
        den = torch.clamp(den, min=1e-10)
        return torch.sqrt(num / den).cpu().numpy()

    def one_step_da(self, gt, xb, yo, H, R):
        cfg = self.cfg
        H_old = H
        if cfg.use_eval:
            H = H * (1.0 - self._mask_eval_dev())[None]
        w_bg = self._score("bg", xb, gt[0])
        if self.verbose:
            print(f"  bg: z500 {w_bg[11]:.4g} t850 {w_bg[66]:.4g} t2m {w_bg[2]:.4g}",
                  flush=True)
        t0 = time.perf_counter()
        self.last_reduce_s = 0.0
        z = None  # the solve's control
        if cfg.da_mode == "free_run":
            xa = baselines.free_run_analysis(xb)
            diag = SolveDiagnostics()
        elif cfg.da_mode == "interpolation":
            xa = self._dev(baselines.interpolation_analysis(
                xb.cpu().numpy(), self._host(yo[0]), self._host(H[0]),
                real_obs=self.is_real_obs, dim_out=cfg.interp_dim))
            diag = SolveDiagnostics(seconds=time.perf_counter() - t0)
        else:
            bundle = cost_mod.ObsBundle(xb=xb, yo=yo, H=H, R=R)
            if self._reduce_obs is not None:
                bundle = self._reduce_obs(bundle, cfg.solver_hw)
            self._sync()
            self.last_reduce_s = time.perf_counter() - t0
            shape = ((channels.N_CHANNELS, *cfg.solver_hw) if cfg.da_mode == "sc4dvar"
                     else cfg.latent_shape)
            x0 = torch.zeros(shape, dtype=torch.float32, device=self.device)
            z, xa, diag = self._solver.solve(x0, bundle, nit=cfg.nit, gt=gt,
                                             verbose=self.verbose, name=cfg.da_mode)
            del bundle
        self.last_diag = diag
        self._check_lockstep(*[t for t in (z, xa) if t is not None])
        if cfg.use_eval:
            self.metrics_list["error_obs"].append(self._obs_holdout_error(xa, yo[0], H_old[0]))
        w_ana = self._score("ana", xa, gt[0])
        if self.verbose:
            print(f"  ana: z500 {w_ana[11]:.4g} t850 {w_ana[66]:.4g} "
                  f"t2m {w_ana[2]:.4g}", flush=True)
        return xa

    def _save_intermediate(self, current_time, xb, xa, gt, yo):
        """Optional per-cycle field dumps (da_4dvar.py:713-722; the reference
        writes the truth and obs under intermediate/ground_truth, here
        everything lands in work_dir). The obs tiles are gathered on every
        rank; rank 0 writes."""
        stamp = str(current_time).replace(" ", "_")
        dumps = {"xb": (self.save_field, xb), "xa": (self.save_field, xa),
                 "gt": (self.save_gt, gt), "obs": (self.save_obs, yo)}
        for name, (on, x) in dumps.items():
            if on:
                x = self._host(x) if name == "obs" else x.detach().cpu().numpy()
                if self._writes:
                    np.save(os.path.join(self.work_dir, f"{name}_{stamp}"), x)

    def _forecast_eval(self, xa, current_time):
        """Multi-step forecast WRMSE from the analysis: per lead a (69,)
        physical-unit WRMSE against the truth, one (leads, 69) row per cycle
        in metrics_list["forecast_wrmse"]. Stops where the truth ends."""
        x, t, rows = xa, current_time, []
        for _ in range(self.forecast_eval_steps):
            x = self.advance(x)
            t = t + CYCLE
            has = getattr(self.state_source, "has", None)
            if has is not None and not has(t):
                break
            try:
                gt = self.state_source.get_state(t)
            except FileNotFoundError:
                break
            rows.append(score(x, self._dev(gt))[0])
        if rows:
            self.metrics_list["forecast_wrmse"].append(np.stack(rows))

    # --- main loop --------------------------------------------------------

    def _prefetch(self, current_time):
        """get_obs_info on the prefetch worker: ((yo, H, R, gt), info,
        seconds, done). On a CUDA device its device work goes on the obs
        stream and `done` is an event recorded there after it; the seconds
        end when that event is reached, not when the device is idle."""
        info, t0 = {}, time.perf_counter()
        if self._obs_stream is None:
            obs = self.get_obs_info(current_time, info)
            return obs, info, time.perf_counter() - t0, None
        with torch.cuda.device(self._obs_stream.device), torch.cuda.stream(self._obs_stream):
            obs = self.get_obs_info(current_time, info)
            done = torch.cuda.Event()
            done.record(self._obs_stream)
        done.synchronize()
        return obs, info, time.perf_counter() - t0, done

    def _take(self, fut):
        """The prefetched obs on the loop's thread, a worker's exception
        raised here. On a CUDA device the loop's stream waits on the
        worker's event, and each tensor is marked as used on that stream,
        so the caching allocator hands its memory to no later prefetch
        before the kernels queued on it are done."""
        obs, info, secs, done = fut.result()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in obs:
                t.record_stream(stream)
        return obs, info, secs

    @staticmethod
    @torch.no_grad()
    def _checksum(*xs):
        """Sum and 2-norm of each tensor, the cycle log's record of the obs
        the solve received: reductions in a fixed order, so equal tensors
        give equal numbers, and no temporary of the tensor's size."""
        return torch.stack([v for x in xs for v in (x.sum(), torch.linalg.vector_norm(x))]
                           ).tolist()

    def run_assimilation(self, start_time, end_time):
        """The 6 h cycle loop (da_4dvar.py:1314-1342); returns the last xb.

        With `prefetch_obs`, one worker thread prepares the next cycle's obs
        under the current solve (vaevar_tpu/da/cycler.py:576-632). With
        forecast_eval the next prefetch starts only after `_forecast_eval`:
        both read the truth from `state_source`, and a ReferenceLayoutStore
        shares one native pool between its readers. Each cycle_log entry
        holds the obs preparation's seconds (`obs_s`, on the worker under
        prefetch) and the seconds the loop waited for it (`obs_wait_s`)."""
        start_time, end_time = parse_time(start_time), parse_time(end_time)
        current_time, xb = self.get_current_states(start_time)
        # every rank starts from the same state (the spin-up, or the file),
        # before rank 0 writes anything
        self._check_lockstep(xb, torch.tensor(current_time.timestamp(), dtype=torch.float64))
        epoch = 0
        pool = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="obs-prefetch")
                if self.prefetch_obs else None)
        fut = (pool.submit(self._prefetch, current_time)
               if pool is not None and current_time + CYCLE <= end_time else None)
        try:
            while current_time + CYCLE <= end_time:
                if self.verbose:
                    print(f"cycle @ {current_time}", flush=True)
                t0 = time.perf_counter()
                if pool is None:
                    info = {}
                    obs = self.get_obs_info(current_time, info)
                    self._sync()
                    obs_s = time.perf_counter() - t0
                else:
                    obs, info, obs_s = self._take(fut)
                obs_wait_s = time.perf_counter() - t0
                yo, H, R, gt = obs
                del obs
                keys = [k for k in ("n_gridded", "n_kept") if k in info]
                if self.mesh is not None and keys:  # the obs counts of every rank's tile
                    counts = torch.tensor([info[k] for k in keys], dtype=torch.float64)
                    (counts,) = pmesh.sum_over_tiles(self._tile, counts)
                    info.update(zip(keys, counts.tolist()))
                self.last_obs_info = info
                checksum = self._checksum(yo, H, gt)
                obs_bytes = sum(t.numel() * t.element_size() for t in (yo, H))
                nxt = current_time + CYCLE
                submit_next = pool is not None and nxt + CYCLE <= end_time
                fut = None
                if submit_next and not self.forecast_eval:
                    fut = pool.submit(self._prefetch, nxt)
                xa = self.one_step_da(gt, xb, yo, H, R)
                self._save_intermediate(current_time, xb, xa, gt, yo)
                del yo, H, R, gt
                if self.forecast_eval:
                    # before the on-disk snapshot, so a preemption never leaves
                    # forecast_wrmse a row behind ana_wrmse; before the next
                    # prefetch, whose truth reads must not run beside these
                    self._forecast_eval(xa, current_time)
                    if submit_next:
                        fut = pool.submit(self._prefetch, nxt)
                self.save_eval_result()
                xb = self.advance(xa)
                if epoch % self.cfg.save_interval == 0:
                    self.save_ckpt(nxt, xb)
                    self.save_eval_result(consolidate=True)
                self._sync()
                secs = time.perf_counter() - t0
                self.timings["cycle_s"].append(secs)
                d = self.last_diag
                self.cycle_log.append({
                    "time": str(current_time), "seconds": secs, "obs_s": obs_s,
                    "obs_wait_s": obs_wait_s, **info, "obs_checksum": checksum,
                    "obs_bytes": obs_bytes, "param_bytes": self.param_bytes,
                    "reduce_s": self.last_reduce_s, "solve_s": d.seconds,
                    "jb": list(d.loss_reg), "jo": list(d.loss_obs),
                    "linesearch": d.linesearch, "n_iters": list(d.n_iters),
                    "n_evals": list(d.n_evals), "n_jvp": list(d.n_jvp),
                    "n_restore": list(d.n_restore),
                    "xa_finite": bool(torch.isfinite(xa).all()),
                    "xb_next_finite": bool(torch.isfinite(xb).all()),
                })
                current_time = nxt
                epoch += 1
                if self.verbose:
                    print(f"  cycle took {secs:.2f}s", flush=True)
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
        self.save_ckpt(current_time, xb)
        self.save_eval_result(consolidate=True)
        return xb
