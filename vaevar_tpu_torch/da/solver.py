"""Outer variational solve with per-iteration diagnostics.

Port of vaevar_tpu/da/solver.py:75-291, 344-357 for the da_win = 1 path:
`nit` L-BFGS segments of `lbfgs_iters` iterations on one carried optimizer
state (the reference's one torch LBFGS stepped nit times), with WRMSE/bias
and (Jb, Jo) against truth before each segment and after the last.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.da.lbfgs import lbfgs_init_state, lbfgs_minimize
from vaevar_tpu_torch.utils import metrics as M


@dataclass
class SolveDiagnostics:
    wrmse: list = field(default_factory=list)  # per outer iter, (69,)
    bias: list = field(default_factory=list)
    loss_reg: list = field(default_factory=list)
    loss_obs: list = field(default_factory=list)
    n_iters: list = field(default_factory=list)  # per segment
    n_evals: list = field(default_factory=list)
    seconds: float = 0.0


def resolve_linesearch(linesearch: str) -> str:
    if linesearch == "auto":
        print("[solver] lbfgs_linesearch 'auto' resolves to 'zoom' "
              "(jvp-zoom is ROADMAP A.7)", flush=True)
        return "zoom"
    if linesearch != "zoom":
        raise NotImplementedError(
            f"lbfgs_linesearch {linesearch!r}: only 'zoom' is ported "
            "(jvp-zoom: ROADMAP A.7)")
    return linesearch


class VariationalSolver:
    """Runs L-BFGS segments on cost(x, bundle) with diagnostics between them."""

    def __init__(self, cost: Callable, to_state: Callable, cost_parts: Callable,
                 lbfgs_iters: int = 10, history: int = 10,
                 max_segment_evals: int | None = None, linesearch: str = "zoom"):
        self.cost = cost
        self.to_state = to_state
        self.cost_parts = cost_parts
        self.lbfgs_iters = lbfgs_iters
        self.history = history
        # torch's per-.step() closure-eval budget (max_iter * 5 // 4)
        self.max_segment_evals = (max_segment_evals if max_segment_evals is not None
                                  else lbfgs_iters * 5 // 4)
        resolve_linesearch(linesearch)  # only "zoom" runs; others raise

    @torch.no_grad()
    def diagnostics(self, x, bundle, gt0):
        """(wrmse (69,), bias (69,), Jb, Jo) of the state decoded from x."""
        mean = torch.as_tensor(channels.MEAN, dtype=torch.float32,
                               device=x.device).reshape(-1, 1, 1)
        std = torch.as_tensor(channels.STD, dtype=torch.float32, device=x.device)
        xhat_n = (self.to_state(x, bundle) - mean) / std.reshape(-1, 1, 1)
        gt_n = (gt0 - mean) / std.reshape(-1, 1, 1)
        wrmse = M.weighted_rmse(xhat_n[None], gt_n[None]) * std
        bias = M.weighted_bias((xhat_n - gt_n)[None]) * std
        jb, jo = self.cost_parts(x, bundle)
        return wrmse.cpu().numpy(), bias.cpu().numpy(), float(jb), float(jo)

    def solve(self, x0, bundle, nit: int = 4, gt=None, verbose: bool = True,
              name: str = "da"):
        """-> (x, analysis state, SolveDiagnostics)."""
        diag = SolveDiagnostics()
        t0 = time.perf_counter()
        x, state = x0, lbfgs_init_state(x0, self.history)

        def fun(q):
            return self.cost(q, bundle)

        for kk in range(nit + 1):
            if gt is not None:
                self._record_iter(diag, *self.diagnostics(x, bundle, gt[0]), kk,
                                  verbose, name)
            if kk < nit:
                res = lbfgs_minimize(fun, x, max_iters=self.lbfgs_iters,
                                     history=self.history, init_state=state,
                                     max_evals=self.max_segment_evals)
                x, state = res.x, res.state
                diag.n_iters.append(res.n_iters)
                diag.n_evals.append(res.n_evals)
        with torch.no_grad():
            xa = self.to_state(x, bundle)
        diag.seconds = time.perf_counter() - t0
        return x, xa, diag

    @staticmethod
    def _record_iter(diag, wrmse, bias, jb, jo, kk, verbose, name):
        diag.wrmse.append(np.asarray(wrmse))
        diag.bias.append(np.asarray(bias))
        diag.loss_reg.append(jb)
        diag.loss_obs.append(jo)
        if verbose:
            w = np.asarray(wrmse)
            print(f"[{name}] iter {kk}: z500 {w[11]:.4g} q500 {w[24]:.4g} "
                  f"t2m {w[2]:.4g} t850 {w[66]:.4g} u500 {w[37]:.4g} "
                  f"v500 {w[50]:.4g} Jb {jb:.4g} Jo {jo:.4g}", flush=True)
