"""Cycled data assimilation loop: background -> analysis -> 6 h forecast.

Port of vaevar_tpu/da/cycler.py for vae4dvar and sc4dvar with synthetic
observations: spin-up (`get_initial_state`), per-cycle truth frames at 1 h
steps over the window and obs masks drawn from one seeded generator in cycle
order, R with the model error Q for the window's later slots, the solve
through the VAE decoder (vae4dvar) or the control-variable transform B^1/2
(sc4dvar, `cvt`), in 3D-Var or in 4D-Var with the hourly flow model inside
J, the forecast advance, per-cycle metrics appended to `metrics_log.jsonl` and
consolidated into `<metric>.npy` dumps, and a restartable on-disk state
(`xb.npy` + `current_time.txt`). Obs preparation runs serially (the
reference's obs prefetch thread changes no number). The forecast model runs
under torch.no_grad(): no cost differentiates through the advance.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Callable

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.config import DAConfig
from vaevar_tpu_torch.da import cost as cost_mod
from vaevar_tpu_torch.da import obs as obs_mod
from vaevar_tpu_torch.da.solver import VariationalSolver
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
    work_dir: str = "da_cycle_results/run"
    seed: int = 0
    device: str = "cpu"
    verbose: bool = True
    metrics_list: dict = field(default_factory=lambda: {k: [] for k in _METRIC_KEYS})

    def __post_init__(self):
        cfg = self.cfg
        if cfg.da_mode not in ("vae4dvar", "sc4dvar"):
            raise NotImplementedError(
                f"da_mode {cfg.da_mode!r}: only vae4dvar and sc4dvar are ported "
                "(free_run/interpolation: ROADMAP A.11b)")
        role = "decoder" if cfg.da_mode == "vae4dvar" else "cvt"
        if getattr(self, role) is None:
            raise ValueError(f"da_mode {cfg.da_mode!r} needs a {role}")
        if cfg.init_tp not in (0, 1):
            raise NotImplementedError(f"init_tp {cfg.init_tp}: ROADMAP A.11b")
        os.makedirs(self.work_dir, exist_ok=True)
        self._rng = np.random.default_rng(self.seed)
        q = obs_mod.load_q_matrix(self.coeff_dir or ".", cfg.q_type,
                                  cfg.da_win) if cfg.da_win > 1 else None
        self.R = obs_mod.build_R(
            obs_mod.obs_error_variance(cfg.obs_std, cfg.modify_tp), q, cfg.da_win)
        self._load_metrics()
        for model in (self.decoder, self.flow):
            if model is not None:
                model.requires_grad_(False)
        self._solver = self._build_solver()
        # per-run record: spin-up seconds and, per cycle, seconds and the
        # solver's (Jb, Jo) trace
        self.timings = {"spin_up_s": None, "cycle_s": []}
        self.cycle_log: list[dict] = []

    @property
    def _reducible(self):
        """Per-channel synthetic obs with a nearest upsample: the obs term
        reduces exactly onto the solver grid (cost.ReducedObs for 3D-Var,
        cost.ReducedWindowObs for windows); a window without a flow model
        keeps the full windowed form."""
        return not (self.cfg.da_win > 1 and self.flow is None)

    @property
    def _use_reduced_obs(self):
        return self._reducible and self.cfg.da_win == 1

    def _build_solver(self):
        """The cost of the configuration (vaevar_tpu/da/cycler.py:182-257):
        the reduced 3D-Var cost, the reduced window cost or the full windowed
        cost of the mode, with the obs reduction it takes
        (`self._reduce_obs`). sc4dvar runs at most 5 L-BFGS iterations per
        segment (da_4dvar.py:1119), with the eval budget derived from them."""
        cfg = self.cfg
        sc = cfg.da_mode == "sc4dvar"
        if self._use_reduced_obs:
            c, to_state, parts = (
                cost_mod.make_sc4dvar_cost_reduced(self.cvt.increment, cfg.obs_coeff) if sc
                else cost_mod.make_vae4dvar_cost_reduced(self.decoder, cfg.obs_coeff))
            self._reduce_obs = cost_mod.reduce_obs
        elif self._reducible:  # da_win > 1
            make = (cost_mod.make_sc4dvar_cost_window_reduced if sc
                    else cost_mod.make_vae4dvar_cost_window_reduced)
            c, to_state, parts = make(
                self.cvt.increment if sc else self.decoder, self.flow, da_win=cfg.da_win,
                obs_coeff=cfg.obs_coeff, step_checkpoint=cfg.window_step_checkpoint)
            self._reduce_obs = cost_mod.reduce_obs_window
        else:
            make = cost_mod.make_sc4dvar_cost if sc else cost_mod.make_vae4dvar_cost
            c, to_state, parts = make(
                self.cvt if sc else self.decoder, self.flow, flow_hw=cfg.solver_hw,
                da_win=cfg.da_win, obs_coeff=cfg.obs_coeff)
            self._reduce_obs = None
        return VariationalSolver(
            c, to_state, parts, lbfgs_iters=min(cfg.lbfgs_iters, 5) if sc else cfg.lbfgs_iters,
            history=cfg.lbfgs_history, max_segment_evals=cfg.lbfgs_max_evals,
            linesearch=cfg.lbfgs_linesearch)

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)

    def _sync(self):
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

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
        the log."""
        new = []
        for k, v in self.metrics_list.items():
            for i in range(self._flushed.get(k, 0), len(v)):
                val = v[i]
                new.append({"k": k, "i": i,
                            "v": val.tolist() if hasattr(val, "tolist") else val})
            self._flushed[k] = len(v)
        if new:
            with open(os.path.join(self.work_dir, "metrics_log.jsonl"), "a") as f:
                for e in new:
                    f.write(json.dumps(e) + "\n")
        if not consolidate:
            return
        for k, v in self.metrics_list.items():
            np.save(os.path.join(self.work_dir, k), np.asarray(v))
        open(os.path.join(self.work_dir, "metrics_log.jsonl"), "w").close()

    def save_ckpt(self, current_time, xb):
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
        """Spin-up per init_tp (da_4dvar.py:649-664)."""
        cfg = self.cfg
        x0 = self._dev(self.state_source.get_state(start_time - cfg.init_lag * CYCLE))
        if cfg.init_tp == 0:
            return self.forecast_integrate(x0, cfg.init_lag, True)
        return x0

    @torch.no_grad()
    def advance(self, xa):
        return self.forecast_integrate(xa, 1, True)

    # --- per-cycle pieces -------------------------------------------------

    def get_obs_info(self, current_time):
        """(yo, H, R, gt): noiseless synthetic obs = truth at mask points, one
        frame per hourly slot of the window."""
        cfg = self.cfg
        gt = np.stack([self.state_source.get_state(current_time + t * STEP)
                       for t in range(cfg.da_win)])  # (T, 69, H, W)
        H = obs_mod.make_obs_mask(cfg.obs_type, cfg.da_win, cfg.grid_hw, self._rng)
        gt_d = self._dev(gt)
        return gt_d, self._dev(H), self._dev(self.R), gt_d

    def _score(self, prefix, x, gt0):
        wrmse, bias, mse = score(x, gt0)
        self.metrics_list[f"{prefix}_wrmse"].append(wrmse)
        self.metrics_list[f"{prefix}_bias"].append(bias)
        self.metrics_list[f"{prefix}_mse"].append(mse)
        return wrmse

    def one_step_da(self, gt, xb, yo, H, R):
        cfg = self.cfg
        w_bg = self._score("bg", xb, gt[0])
        if self.verbose:
            print(f"  bg: z500 {w_bg[11]:.4g} t850 {w_bg[66]:.4g} t2m {w_bg[2]:.4g}",
                  flush=True)
        t0 = time.perf_counter()
        bundle = cost_mod.ObsBundle(xb=xb, yo=yo, H=H, R=R)
        if self._reduce_obs is not None:
            bundle = self._reduce_obs(bundle, cfg.solver_hw)
        self._sync()
        self.last_reduce_s = time.perf_counter() - t0
        shape = ((channels.N_CHANNELS, *cfg.solver_hw) if cfg.da_mode == "sc4dvar"
                 else cfg.latent_shape)
        x0 = torch.zeros(shape, dtype=torch.float32, device=self.device)
        _, xa, diag = self._solver.solve(x0, bundle, nit=cfg.nit, gt=gt,
                                         verbose=self.verbose, name=cfg.da_mode)
        self.last_diag = diag
        w_ana = self._score("ana", xa, gt[0])
        if self.verbose:
            print(f"  ana: z500 {w_ana[11]:.4g} t850 {w_ana[66]:.4g} "
                  f"t2m {w_ana[2]:.4g}", flush=True)
        return xa

    # --- main loop --------------------------------------------------------

    def run_assimilation(self, start_time, end_time):
        """The 6 h cycle loop (da_4dvar.py:1314-1342); returns the last xb."""
        start_time, end_time = parse_time(start_time), parse_time(end_time)
        current_time, xb = self.get_current_states(start_time)
        epoch = 0
        while current_time + CYCLE <= end_time:
            if self.verbose:
                print(f"cycle @ {current_time}", flush=True)
            t0 = time.perf_counter()
            yo, H, R, gt = self.get_obs_info(current_time)
            self._sync()
            obs_s = time.perf_counter() - t0
            xa = self.one_step_da(gt, xb, yo, H, R)
            del yo, H, R, gt
            self.save_eval_result()
            xb = self.advance(xa)
            nxt = current_time + CYCLE
            if epoch % self.cfg.save_interval == 0:
                self.save_ckpt(nxt, xb)
                self.save_eval_result(consolidate=True)
            self._sync()
            secs = time.perf_counter() - t0
            self.timings["cycle_s"].append(secs)
            d = self.last_diag
            self.cycle_log.append({
                "time": str(current_time), "seconds": secs, "obs_s": obs_s,
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
        self.save_ckpt(current_time, xb)
        self.save_eval_result(consolidate=True)
        return xb
