"""L-BFGS with a strong-Wolfe zoom linesearch, run eagerly on torch tensors.

Port of vaevar_tpu/da/lbfgs.py:98-401, which is optax 0.2.6's `lbfgs`
(two-loop recursion, identity scale from the last curvature pair, capped
1/|g| on the first step) chained with
`scale_by_zoom_linesearch(max_linesearch_steps=25,
initial_guess_strategy="one")` (Nocedal & Wright algorithms 3.5/3.6 with the
Hager-Zhang approximate decrease test), under torch.optim.LBFGS's stopping
rules: entry/per-iteration max|g| <= tolerance_grad, no-progress
tolerance_change, and a closure-eval budget of max_iters*5//4 per segment
with one eval charged at segment entry.

Two linesearches: "zoom" pays a value and gradient at every probe;
"jvp-zoom" (`scale_by_jvp_zoom_linesearch` of the reference) pays one at the
first probe and one `torch.func.jvp` along the direction at each later
probe, and restores the true gradient at the accepted point. The zoom's
decisions read only the value and the slope, so both take the same steps;
the charged evals are the probes in both.

Vector work stays on the tensors' device. The linesearch's scalar decisions
run on the host in numpy float32, so each comparison and interpolation
rounds as the JAX program's f32 arithmetic does. `init_state` continues a
minimisation across segments (curvature pairs, cached value and gradient),
as the reference's one torch optimizer persists across its Nit .step()
calls.

Spans (utils/trace.py): `lbfgs.probe` around each value and gradient, jvp
or restore the minimisation runs, up to its host read of the value and
slope (attr `kind`: "entry", "grad", "jvp" or "restore"); inside it the
evaluation's own (`Eager`: `lbfgs.forward` and `lbfgs.backward`, or
`lbfgs.jvp`; a solve's: da/graphs.py); `lbfgs.direction` around the
two-loop product; `host_sync` around every device-to-host read. Counters:
`lbfgs.probes` (the probe spans), `lbfgs.jvp`, `lbfgs.restores`,
`host_syncs`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from vaevar_tpu_torch.utils import trace

f32 = np.float32
_INF = f32(np.inf)

# optax zoom_linesearch defaults (optax/_src/linesearch.py:576-585, 1331-1340)
_INCREASE = f32(2.0)
_SLOPE_RTOL = f32(1e-4)
_CURV_RTOL = f32(0.9)
_APPROX_DEC_RTOL = f32(1e-6)
_APPROX_SLOPE = f32(2 * 1e-4 - 1.0)
_INTERVAL_THRESHOLD = f32(1e-5)
LINESEARCHES = ("zoom", "jvp-zoom")


def _dot(a, b) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _host(t) -> np.float32:
    if not isinstance(t, torch.Tensor):
        return f32(t)
    trace.count("host_syncs")
    with trace.span("host_sync"):
        return f32(t.item())


def _probe(kind: str):
    """The span of one value and gradient, jvp or restore, counted."""
    trace.count("lbfgs.probes")
    if kind == "jvp":
        trace.count("lbfgs.jvp")
    elif kind == "restore":
        trace.count("lbfgs.restores")
    return trace.span("lbfgs.probe", kind=kind)


@dataclass
class LBFGSState:
    """Optimizer state carried across segments (optax's lbfgs state plus the
    linesearch's cached value and gradient at the current point)."""

    count: int
    params: torch.Tensor  # x at the last update
    updates: torch.Tensor  # gradient at the last update
    dw: torch.Tensor  # (m, *shape) parameter differences
    du: torch.Tensor  # (m, *shape) gradient differences
    rho: torch.Tensor  # (m,) 1 / <du, dw>
    value: np.float32  # inf until the first linesearch
    grad: torch.Tensor


@dataclass
class LBFGSResult:
    x: torch.Tensor
    value: np.float32
    n_iters: int
    n_evals: int  # charged: the entry eval and every linesearch probe
    state: LBFGSState
    n_jvp: int = 0  # probes that paid a jvp instead of a value and gradient
    n_restore: int = 0  # uncharged value and gradient at accepted jvp probes


def _check_linesearch(linesearch: str):
    if linesearch not in LINESEARCHES:
        raise ValueError(f"unknown linesearch {linesearch!r} (expected 'zoom' or 'jvp-zoom')")


def lbfgs_init_state(x0, history: int = 10, linesearch: str = "zoom") -> LBFGSState:
    """Fresh optimizer state; both linesearches carry the same state."""
    _check_linesearch(linesearch)
    z = torch.zeros_like(x0)
    mem = torch.zeros((history, *x0.shape), dtype=x0.dtype, device=x0.device)
    return LBFGSState(
        count=0, params=z, updates=z.clone(), dw=mem, du=mem.clone(),
        rho=torch.zeros(history, dtype=x0.dtype, device=x0.device),
        value=_INF, grad=torch.zeros_like(x0))


def value_and_grad(fun: Callable, x):
    """(value as np.float32, gradient) of a scalar torch function."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        with trace.span("lbfgs.forward"):
            v = fun(xg)
        with trace.span("lbfgs.backward"):
            (g,) = torch.autograd.grad(v, xg)
    return _host(v), g


def value_and_slope(fun: Callable, x, u):
    """(value, slope along u) of a scalar torch function as device scalars,
    by one forward-mode torch.func.jvp; no backward graph is recorded."""
    with torch.no_grad(), trace.span("lbfgs.jvp"):
        return torch.func.jvp(fun, (x.detach(),), (u,))


class Eager:
    """The evaluations of `fun` that L-BFGS runs, op by op."""

    def __init__(self, fun: Callable):
        self.fun = fun

    def value_and_grad(self, x):
        return value_and_grad(self.fun, x)

    def value_and_slope(self, x, u):
        return value_and_slope(self.fun, x, u)


def _lbfgs_direction(st: LBFGSState, x, g):
    """optax scale_by_lbfgs update (transform.py:1676-1751): refresh the
    memory with the newest pair, then the two-loop product P_k g."""
    m = st.rho.shape[0]
    mem_idx, prev_idx = st.count % m, (st.count - 1) % m
    if st.count > 0:
        dwi, dui = x - st.params, g - st.updates
        vd = _dot(dui, dwi)
        weight = torch.where(vd == 0, torch.zeros_like(vd), 1.0 / vd)
        gamma = torch.where(_dot(dui, dui) > 0, vd / _dot(dui, dui),
                            torch.ones_like(vd))
    else:
        dwi, dui = torch.zeros_like(x), torch.zeros_like(g)
        weight = torch.zeros((), dtype=g.dtype, device=g.device)
        gamma = torch.clamp(1.0 / torch.sqrt(_dot(g, g)), max=1.0)
    st.dw[prev_idx] = dwi
    st.du[prev_idx] = dui
    st.rho[prev_idx] = weight
    order = [(mem_idx + i) % m for i in range(m)]
    vec, alphas = g, {}
    for i in reversed(order):
        alphas[i] = st.rho[i] * _dot(st.dw[i], vec)
        vec = vec + (-alphas[i]) * st.du[i]
    vec = gamma * vec
    for i in order:
        beta = st.rho[i] * _dot(st.du[i], vec)
        vec = vec + (alphas[i] - beta) * st.dw[i]
    st.count += 1
    st.params, st.updates = x, g
    return vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa, fpa), (b, fb), (c, fc)
    (optax linesearch.py:455-493); NaN when none exists."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * (dc * dc))) * v0 + db * (db * db) * v1) / denom
    radical = B * B - f32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (f32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa, fpa), (b, fb)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (f32(2.0) * B)


# np.maximum/np.minimum propagate NaN like jnp's; Python's max/min do not.
def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = np.maximum(slope - _APPROX_SLOPE * slope_init,
                        value - value_init - _APPROX_DEC_RTOL * abs(value_init))
    err = np.maximum(np.minimum(approx, err), f32(0.0))
    return _INF if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(abs(slope) - _CURV_RTOL * abs(slope_init), f32(0.0))
    return _INF if np.isnan(err) else err


@dataclass
class LinesearchResult:
    stepsize: np.float32
    value: np.float32
    grad: torch.Tensor
    n_probes: int
    n_jvp: int = 0
    n_restore: int = 0


def zoom_linesearch(evaluations, params, updates, value, grad, max_steps: int = 25,
                    jvp_probes: bool = False) -> LinesearchResult:
    """optax's zoom linesearch (linesearch.py:815-1282) from stepsize 1, at
    the accepted point.

    With `jvp_probes` (the reference's scale_by_jvp_zoom_linesearch,
    vaevar_tpu/da/lbfgs.py:175-237), probes after the first pay one jvp and
    store the pseudo-gradient (slope / |u|^2) u, whose dot with u gives the
    slope the decisions read; the true (value, grad) at the accepted point is
    the first probe's or the entry's when the stepsize is theirs, else one
    uncharged value_and_grad. `evaluations` (see Eager) runs every
    evaluation."""
    slope = _host(_dot(updates, grad))
    s = dict(stepsize=f32(0.0), value=value, grad=grad, slope=slope,
             low=f32(0.0), value_low=value, slope_low=slope,
             high=f32(0.0), value_high=value, slope_high=slope,
             cubic_ref=f32(0.0), value_cubic_ref=value,
             safe_stepsize=f32(0.0), safe_value=value, safe_grad=grad,
             decrease_error=_INF)
    value_init, slope_init = value, slope
    count, interval_found, done, failed = 0, False, False, False

    u_sq = _dot(updates, updates)
    n_jvp = 0

    def probe(eta):
        nonlocal n_jvp
        jvp = jvp_probes and count > 0
        with _probe("jvp" if jvp else "grad"):
            w = params + float(eta) * updates
            if jvp:
                v, sl = evaluations.value_and_slope(w, updates)
                coef = torch.where(u_sq > 0.0, sl.float() / torch.clamp(u_sq, min=1e-38),
                                   torch.zeros_like(u_sq))
                v, g = _host(v), coef * updates
                n_jvp += 1
            else:
                v, g = evaluations.value_and_grad(w)
            return v, g, _host(_dot(g, updates))

    with np.errstate(all="ignore"):
        while not (done or failed):
            if not interval_found:  # algorithm 3.5: search an interval
                prev_eta, prev_v, prev_sl = s["stepsize"], s["value"], s["slope"]
                eta = f32(1.0) if count == 0 else _INCREASE * prev_eta
                v, g, sl = probe(eta)
                dec = _decrease_error(eta, v, sl, value_init, slope_init)
                err = np.maximum(dec, _curvature_error(sl, slope_init))
                if dec <= 0.0:
                    s.update(safe_stepsize=eta, safe_value=v, safe_grad=g)
                set_high = dec > 0.0 or (v >= prev_v and count > 0)
                set_low = sl >= 0.0 and not set_high
                if set_low:
                    lo, hi = (eta, v, sl), (prev_eta, prev_v, prev_sl)
                else:
                    lo, hi = (prev_eta, prev_v, prev_sl), (eta, v, sl)
                s.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                         high=hi[0], value_high=hi[1], slope_high=hi[2],
                         cubic_ref=lo[0], value_cubic_ref=lo[1])
                interval_found = set_high or set_low or err <= 0.0
                done = err <= 0.0
                failed = count + 1 >= max_steps and not done
            else:  # algorithm 3.6: zoom into [low, high]
                low, high = s["low"], s["high"]
                vlow, slow = s["value_low"], s["slope_low"]
                delta = abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                cubic = _cubicmin(low, vlow, slow, high, s["value_high"],
                                  s["cubic_ref"], s["value_cubic_ref"])
                quad = _quadmin(low, vlow, slow, high, s["value_high"])
                if left + f32(0.2) * delta < cubic < right - f32(0.2) * delta:
                    eta = cubic
                elif left + f32(0.1) * delta < quad < right - f32(0.1) * delta:
                    eta = quad
                else:
                    eta = (low + high) / f32(2.0)
                v, g, sl = probe(eta)
                dec = _decrease_error(eta, v, sl, value_init, slope_init)
                err = np.maximum(dec, _curvature_error(sl, slope_init))
                if dec <= 0.0 and v < s["safe_value"]:
                    s.update(safe_stepsize=eta, safe_value=v, safe_grad=g)
                done = err <= 0.0
                set_high_mid = dec > 0.0 or v >= vlow
                set_high_low = sl * (high - low) >= 0.0 and not set_high_mid
                old_high = (high, s["value_high"])
                if set_high_mid:
                    s.update(high=eta, value_high=v, slope_high=sl)
                if set_high_low:
                    s.update(high=low, value_high=vlow, slope_high=slow)
                if not set_high_mid:
                    s.update(low=eta, value_low=v, slope_low=sl)
                if set_high_mid or set_high_low:
                    s.update(cubic_ref=old_high[0], value_cubic_ref=old_high[1])
                else:
                    s.update(cubic_ref=low, value_cubic_ref=vlow)
                too_small = delta <= _INTERVAL_THRESHOLD
                failed = ((count + 1 >= max_steps)
                          or (too_small and s["safe_stepsize"] > 0.0)) and not done
            s.update(stepsize=eta, value=v, grad=g, slope=sl, decrease_error=dec)
            count += 1
            if failed and (s["safe_stepsize"] > 0.0 or np.isinf(s["decrease_error"])):
                s.update(stepsize=s["safe_stepsize"], value=s["safe_value"],
                         grad=s["safe_grad"])
            if count == 1:
                first = (s["stepsize"], s["value"], s["grad"])
    res = LinesearchResult(s["stepsize"], s["value"], s["grad"], count, n_jvp)
    if jvp_probes:  # restore the true (value, grad) at the accepted point
        eta = res.stepsize
        if eta == 0.0:
            res.value, res.grad = value_init, grad
        elif eta == first[0]:
            res.value, res.grad = first[1], first[2]
        else:
            with _probe("restore"):
                res.value, res.grad = evaluations.value_and_grad(params + float(eta) * updates)
            res.n_restore = 1
    return res


def lbfgs_minimize(
    fun: Callable,
    x0,
    max_iters: int = 10,
    history: int = 10,
    tolerance_grad: float = 1e-7,
    tolerance_change: float = 1e-9,
    max_linesearch_steps: int = 25,
    max_evals: int | None = None,
    init_state: LBFGSState | None = None,
    linesearch: str = "zoom",
    evaluations: Eager | None = None,
) -> LBFGSResult:
    """Minimise `fun` (a scalar torch function of one tensor) from `x0` for
    up to `max_iters` more iterations; pass `init_state` (a previous
    result's `.state`, which this call updates) to continue a minimisation.
    `linesearch` is "zoom" or "jvp-zoom" (the cost must then be forward-mode
    differentiable). `evaluations` evaluates `fun` (default Eager(fun)):
    the entry's, the probes' and the restores' values and gradients and the
    jvps. See vaevar_tpu.da.lbfgs.lbfgs_minimize for the stopping rules."""
    _check_linesearch(linesearch)
    evaluations = Eager(fun) if evaluations is None else evaluations
    if max_evals is None:
        max_evals = max_iters * 5 // 4  # torch.optim.LBFGS default
    st = init_state if init_state is not None else lbfgs_init_state(x0, history)
    it0 = st.count
    x = x0
    step_max = dloss = _INF
    evals = 1  # segment entry charges one closure eval, as in torch
    n_jvp = n_restore = 0
    tol_grad, tol_change = f32(tolerance_grad), f32(tolerance_change)
    while True:
        it = st.count
        g_max = _host(st.grad.abs().max())
        opt_cond = g_max <= tol_grad and it > 0
        no_progress = step_max <= tol_change or dloss < tol_change
        if not (it < it0 + max_iters and evals < max_evals and not opt_cond
                and not no_progress):
            break
        if np.isfinite(st.value):  # optax.value_and_grad_from_state
            value, grad = st.value, st.grad
        else:
            with _probe("entry"):
                value, grad = evaluations.value_and_grad(x)
        with trace.span("lbfgs.direction"):
            direction = -_lbfgs_direction(st, x, grad)
        ls = zoom_linesearch(evaluations, x, direction, value, grad, max_linesearch_steps,
                             jvp_probes=linesearch == "jvp-zoom")
        step = float(ls.stepsize) * direction
        x = x + step
        st.value, st.grad = ls.value, ls.grad
        step_max = _host(step.abs().max())
        dloss = abs(ls.value - value)
        evals += ls.n_probes
        n_jvp += ls.n_jvp
        n_restore += ls.n_restore
    return LBFGSResult(x=x, value=st.value, n_iters=st.count, n_evals=evals, state=st,
                       n_jvp=n_jvp, n_restore=n_restore)
