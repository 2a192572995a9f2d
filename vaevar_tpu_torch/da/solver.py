"""Outer variational solve with per-iteration diagnostics.

Port of vaevar_tpu/da/solver.py:66-357 without the XLA dispatch machinery:
`nit` L-BFGS segments of `lbfgs_iters` iterations on one carried optimizer
state (the reference's one torch LBFGS stepped nit times), with WRMSE/bias
and (Jb, Jo) against truth before each segment and after the last. The
linesearch "auto" resolves at the first solve: "jvp-zoom" when the cost is
forward-mode differentiable, else "zoom". Under run_da --mesh SHxSW (or
TPxSHxSW) the bundle's obs fields are this rank's tiles (the cycler tiles
them), and the cost, built on the mesh, sums over the spatial group every
value L-BFGS and the diagnostics read (and a tensor-parallel model sums its
slices over the tp group), so the ranks take the same steps with no solver
change.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from vaevar_tpu_torch import channels
from vaevar_tpu_torch.da.lbfgs import (
    LINESEARCHES,
    lbfgs_init_state,
    lbfgs_minimize,
    value_and_slope,
)
from vaevar_tpu_torch.ops.flash_attn import NoForwardADError
from vaevar_tpu_torch.utils import metrics as M


@dataclass
class SolveDiagnostics:
    wrmse: list = field(default_factory=list)  # per outer iter, (69,)
    bias: list = field(default_factory=list)
    loss_reg: list = field(default_factory=list)
    loss_obs: list = field(default_factory=list)
    n_iters: list = field(default_factory=list)  # per segment
    n_evals: list = field(default_factory=list)  # charged evals
    n_jvp: list = field(default_factory=list)  # of which jvp probes
    n_restore: list = field(default_factory=list)  # uncharged gradient restores
    linesearch: str = ""  # the mode the solve ran
    seconds: float = 0.0


class VariationalSolver:
    """Runs L-BFGS segments on cost(x, bundle) with diagnostics between them."""

    def __init__(self, cost: Callable, to_state: Callable, cost_parts: Callable,
                 lbfgs_iters: int = 10, history: int = 10,
                 max_segment_evals: int | None = None, linesearch: str = "zoom"):
        if linesearch != "auto" and linesearch not in LINESEARCHES:
            raise ValueError(f"lbfgs_linesearch {linesearch!r}: expected 'auto', "
                             "'zoom' or 'jvp-zoom'")
        self.cost = cost
        self.to_state = to_state
        self.cost_parts = cost_parts
        self.lbfgs_iters = lbfgs_iters
        self.history = history
        # torch's per-.step() closure-eval budget (max_iter * 5 // 4)
        self.max_segment_evals = (max_segment_evals if max_segment_evals is not None
                                  else lbfgs_iters * 5 // 4)
        self.linesearch = linesearch  # "auto" until the first solve
        self._jvp_checked = linesearch != "jvp-zoom"

    def _jvp_compatible(self, x0, bundle) -> bool:
        """Whether the cost runs under forward-mode AD: one jvp of the real
        cost at x0 (uncharged). Only the flash attention op, which has no
        forward-mode rule, makes it False; any other failure propagates."""
        try:
            value_and_slope(lambda q: self.cost(q, bundle), x0, torch.ones_like(x0))
        except NoForwardADError:
            return False
        return True

    def ensure_linesearch(self, x0, bundle):
        """Resolve "auto" and check an explicit "jvp-zoom", once per solver
        (vaevar_tpu/da/solver.py:180-197, 326-341)."""
        if self.linesearch == "auto":
            self.linesearch = "jvp-zoom" if self._jvp_compatible(x0, bundle) else "zoom"
            self._jvp_checked = True
            print(f"[solver] lbfgs_linesearch 'auto' resolves to {self.linesearch!r}",
                  flush=True)
        if not self._jvp_checked:
            if not self._jvp_compatible(x0, bundle):
                raise ValueError(
                    "lbfgs_linesearch='jvp-zoom' needs a forward-mode-differentiable "
                    "cost, but this cost runs the flash attention op, which has no "
                    "forward-mode rule (a mask-free attention stage with "
                    "N >= flash_min_seq). Use lbfgs_linesearch='zoom' or 'auto'.")
            self._jvp_checked = True

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
        self.ensure_linesearch(x0, bundle)
        diag = SolveDiagnostics(linesearch=self.linesearch)
        t0 = time.perf_counter()
        x, state = x0, lbfgs_init_state(x0, self.history, self.linesearch)

        def fun(q):
            return self.cost(q, bundle)

        for kk in range(nit + 1):
            if gt is not None:
                self._record_iter(diag, *self.diagnostics(x, bundle, gt[0]), kk,
                                  verbose, name)
            if kk < nit:
                res = lbfgs_minimize(fun, x, max_iters=self.lbfgs_iters,
                                     history=self.history, init_state=state,
                                     max_evals=self.max_segment_evals,
                                     linesearch=self.linesearch)
                x, state = res.x, res.state
                diag.n_iters.append(res.n_iters)
                diag.n_evals.append(res.n_evals)
                diag.n_jvp.append(res.n_jvp)
                diag.n_restore.append(res.n_restore)
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
