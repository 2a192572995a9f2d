"""Driver of a 4D-Var window cell: the port's CycledDA with the flow model
inside J, as run_da builds it for `--da_mode vae4dvar --da_win 6`.

Set-up: the decoder, the flow model (drawn from seed + 1, as run_da draws
it) and the forecast model (weights.draw), the synthetic truth on the
device (synth.DeviceEra5), a CycledDA over a scratch work dir with the flow
model in the cost: the reduced window cost on the solver grid
(`reduce_obs_window`), the obs prefetch, FORECAST_025 as spin-up and 6 h
advance, bf16. Then one `run_assimilation` over 1 + n 6 h cycles (n =
round(seconds / the cell's cycle_s_hint)), plus one profiled cycle with
--trace 1, in which the port's tracing (utils/trace.py) is on and its span
records kept (on the CPU, the records alone: no device trace). Set-up, the
window, `setup_s`, `s_per_cycle` and the wrappers are drivers/da_cycle.py's.
The port's counters are read at the window's start and end (always on; a
program without a counter reads None).

Check, once the window has closed and the program is freed: for
`check_cycles` of the window's cycles drawn from the seed, the plain
float32 reference (reference/da_window.py) works out again, from the
control z the solve returned, the background xb and the slots' truths, the
window cost, its gradient through the decoder and every flow step, and the
rollout, and advances the program's analysis:

- `inc_gap`: |xa - xb - up(dec(z) s)| / |up(dec(z) s)|, in units of each
  channel's std;
- `jo_gap`: the program's Jo at z against the reference's, over the part
  of Jo that the increment sets (Jo(z) - the Jo of xb's own rollout);
- `drop_gap`: the program's J(z) - J(0) against the reference's; infinite
  where the reference's J did not fall;
- `grad_gap`: |g - g_ref| / |g_ref - z| at z, g the gradient of the
  program's own window cost (the solver's, through the decoder's and the
  five flow steps' backward, asked once the window has closed, on the
  reduced window obs the solve was given), over the part of the gradient
  that the obs set;
- `roll_gap`: the program's last slot's state at z from its own rollout
  (cost._window_predict from xa) against the reference's, |x - x_ref| /
  |x_ref - mean|, in std units;
- `adv_gap`: |xb_next - F(xa)| / |F(xa) - mean|, in std units;

each the worst over the cycles checked, held to the cell's `limits`.
"""

from __future__ import annotations

import functools
import gc
import random
import sys
import time
from datetime import datetime, timedelta

import torch

import harness
import models
from drivers.da_cycle import _Cycles, _rel, _std_units
from metrics import _flops
from reference import channels
from reference import da as rda
from reference import da_window as rwin

CHECKS = ("inc_gap", "jo_gap", "drop_gap", "grad_gap", "roll_gap", "adv_gap")


def _trace_module():
    """The port's utils/trace.py, or None for a program without it."""
    try:
        from vaevar_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def run(ctx: harness.Ctx) -> harness.Outcome:
    from devtrace import DeviceTrace
    from synth import DeviceEra5
    from vaevar_tpu_torch.config import DAConfig
    from vaevar_tpu_torch.da.cost import ReducedWindowObs, _window_predict
    from vaevar_tpu_torch.da.cycler import CYCLE, CycledDA
    from vaevar_tpu_torch.da.dynamics import make_integrate
    from vaevar_tpu_torch.da.lbfgs import value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False  # as run_da
    torch.backends.cudnn.allow_tf32 = False
    trace = _trace_module()
    cfg, traffic = ctx.config, ctx.cell["params"]
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    n = max(1, round(ctx.seconds / traffic["cycle_s_hint"]))
    total = 1 + n + int(ctx.trace)
    sampled = sorted(random.Random(ctx.seed).sample(range(1, n + 1),
                                                    min(traffic["check_cycles"], n)))
    da_cfg = dict(cfg["da"], save_interval=cfg["save_interval"])
    win = da_cfg["da_win"]

    decoder = models.program_model(cfg["models"]["decoder"], ctx.seed, "decoder", dev)
    flow = models.program_model(cfg["models"]["flow"], ctx.seed + 1, "decoder", dev)
    forecast = models.program_model(cfg["models"]["forecast"], ctx.seed, "forecast", dev)
    for m in (decoder, flow, forecast):
        m.eval().requires_grad_(False)
    source = DeviceEra5(da_cfg["grid_hw"], ctx.seed, dev)

    # the checked cycles' control, states and window bundle, copied into
    # buffers made now: the same device memory for every seed
    C = len(channels.MEAN)
    state = (C, *da_cfg["grid_hw"])
    low = (C, *da_cfg["solver_hw"])
    keep = {k: {"z": torch.empty(da_cfg["latent_shape"], device=dev),
                **{name: torch.empty(state, device=dev) for name in ("xb", "xa", "xb_next")},
                "xb_low": torch.empty(low, device=dev),
                **{name: torch.empty((win, *low), device=dev) for name in ("a", "ybar")},
                "c": torch.empty(win, device=dev)}
            for k in sampled}
    held = sum(t.numel() * t.element_size() for kp in keep.values() for t in kp.values())
    held += sum(t.numel() * t.element_size() for t in (source.base, source.mode2))
    ends, advance_s, counted = [], {}, {}
    tracer = DeviceTrace(ctx.scratch) if ctx.trace and cuda else None
    peaks, reserved = {}, {}

    def mark(label):
        if tracer is not None:
            tracer.mark(label)

    def on_end(k):
        ends.append(time.perf_counter())
        if trace is not None and k in (1, 1 + n):
            counted[k] = trace.counters()
        if cuda and k in (1, 1 + n):
            peaks[k] = torch.cuda.max_memory_allocated(dev)
            reserved[k] = torch.cuda.max_memory_reserved(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        if ctx.trace and k == 1 + n:  # the traced cycle starts
            if tracer is not None:
                tracer.start("obs take, scoring, reduction")
            if trace is not None:
                trace.enable()
        elif ctx.trace and k == 2 + n:
            if tracer is not None:
                tracer.stop()
            if trace is not None:
                trace.disable()
        else:
            mark("obs take, scoring, reduction")

    integrate = make_integrate(forecast)

    def forecast_integrate(x, steps, interpolation=False):
        if steps != 1:  # the spin-up
            return integrate(x, steps, interpolation)
        k = len(ends)
        mark("advance")
        t0 = time.perf_counter()
        out = integrate(x, steps, interpolation)
        if ctx.trace and cuda:
            torch.cuda.synchronize(dev)
            advance_s[k] = time.perf_counter() - t0
        if k in keep:
            keep[k]["xb_next"].copy_(out)
        mark("cycle end")
        return out

    work_dir = ctx.scratch / "da"
    if work_dir.exists():  # a cycler resumes from a work dir's saved state
        raise FileExistsError(f"{work_dir}: the run needs a fresh work dir")
    da = CycledDA(DAConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in da_cfg.items()}),
                  source, forecast_integrate, decoder, flow=flow,
                  # no Q file there: q_type 1's synthetic Q, as run_da's default
                  # --coeff_dir gives it
                  coeff_dir=str(ctx.scratch / "q_info"),
                  work_dir=str(work_dir), seed=ctx.seed, device=str(dev), verbose=False,
                  prefetch_obs=traffic["prefetch_obs"])
    da.timings["cycle_s"] = _Cycles(on_end)
    solve = da._solver.solve

    def solve_and_keep(x0, bundle, **kw):
        k = len(ends)
        mark("solve")
        z, xa, diag = solve(x0, bundle, **kw)
        if k in keep:
            for name, t in (("z", z), ("xb", bundle.xb), ("xa", xa), ("xb_low", bundle.xb_low),
                            ("a", bundle.a), ("ybar", bundle.ybar), ("c", bundle.c)):
                keep[k][name].copy_(t)
        mark("scoring and dumps")
        return z, xa, diag

    da._solver.solve = solve_and_keep
    start = datetime.fromisoformat(traffic["start_time"])
    da.run_assimilation(start, start + total * CYCLE)
    log = da.cycle_log
    window_s = ends[n] - ends[0]
    peak_window = peaks.get(1 + n, 0)
    memory_peak = max(peaks.values(), default=0)
    reading = tracer.result if tracer is not None else None
    spans = trace.records() if trace is not None and ctx.trace else None
    for k, c in enumerate(log):
        print(f"portbench: cycle {k}: {c['seconds']:.3f} s, solve "
              f"{c['solve_s']:.3f} s, evals {sum(c['n_evals'])} ({sum(c['n_jvp'])} jvp, "
              f"{sum(c['n_restore'])} restores), reduce {c['reduce_s']:.3f} s, obs "
              f"{c['obs_s']:.3f} s (waited {c['obs_wait_s']:.3f} s)"
              + (f", advance {advance_s[k]:.3f} s" if k in advance_s else ""),
              file=sys.stderr, flush=True)
    if cuda:
        print(f"portbench: the window's peak memory {peak_window} bytes allocated, "
              f"{reserved[1 + n]} reserved", file=sys.stderr, flush=True)
    for k in sampled:  # off the clock: the program's own gradient and rollout at z
        kp = keep[k]
        bundle = ReducedWindowObs(xb=kp["xb"], xb_low=kp["xb_low"], a=kp["a"],
                                  ybar=kp["ybar"], c=kp["c"])
        kp["grad"] = value_and_grad(functools.partial(da._solver.cost, bundle=bundle),
                                    kp["z"])[1]
        with torch.no_grad():
            kp["last"] = _window_predict(kp["xa"], flow, tuple(da_cfg["solver_hw"]), win)[-1]
    window_counts = None
    if len(counted) == 2:
        window_counts = {key: counted[1 + n].get(key, 0) - counted[1].get(key, 0)
                         for key in set(counted[1 + n]) | set(counted[1])}
    data = {
        "cycle_log": log[1:1 + n], "window_s": window_s, "advance_s": advance_s,
        "obs_coeff": da_cfg["obs_coeff"], "peak_window_bytes": peak_window,
        "harness_bytes": held, "trace": reading, "spans": spans, "counters": window_counts,
        "da_win": win,
        "model_flops": {role: _flops.lgunet_forward_flops(cfg["models"][role])
                        for role in ("decoder", "flow", "forecast")},
    }
    e2e = {"setup_s": ends[0] - ctx.start, "s_per_cycle": window_s / n}
    failed = sum(not (c["xa_finite"] and c["xb_next_finite"]) for c in log[1:1 + n])
    del da, solve, decoder, flow, forecast, integrate
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, control = check(ctx, cfg, da_cfg, source, start, CYCLE, sampled, keep, log)
    return harness.Outcome(e2e=e2e, data=data, checks=checks, attempted=n, failed=failed,
                           memory_peak_bytes=memory_peak, trace=reading, control_checks=control)


def check(ctx, cfg, da_cfg, source, start, cycle, sampled, keep, log):
    """(checks of the program, checks of the control or []) over the
    sampled cycles, each number the worst of them."""
    dev = torch.device(ctx.device)
    limits = ctx.cell["limits"]
    dec = models.reference_model(cfg["models"]["decoder"], ctx.seed, "decoder", dev)
    flow = models.reference_model(cfg["models"]["flow"], ctx.seed + 1, "decoder", dev)
    fc = models.reference_model(cfg["models"]["forecast"], ctx.seed, "forecast", dev)
    for m in (dec, flow, fc):
        m.eval().requires_grad_(False)
    hw, low = tuple(da_cfg["grid_hw"]), tuple(da_cfg["solver_hw"])
    win, coeff = da_cfg["da_win"], da_cfg["obs_coeff"]
    columns = rda.column_draws(ctx.seed, da_cfg["obs_type"], max(sampled) + 1, hw)
    var = rwin.obs_variances(da_cfg["obs_std"], da_cfg["modify_tp"], win)
    mean = torch.as_tensor(channels.MEAN, dtype=torch.float32, device=dev)[:, None, None]
    worst = dict.fromkeys(CHECKS, 0.0)
    worst_ctl = dict(worst)
    for k in sampled:
        kp, entry = keep[k], log[k]
        z, xb = kp["z"], kp["xb"]
        t0 = start + k * cycle
        obs = rwin.WindowObs([source.state(t0 + t * timedelta(hours=1)) for t in range(win)],
                             columns[k], var)
        zero = torch.zeros_like(z)
        at_z = rwin.window_cost(dec, flow, z, xb, obs, coeff, grad=True)
        j0_ref = rwin.window_cost(dec, flow, zero, xb, obs, coeff)["j"]
        jo_bg = rwin.background_jo(flow, xb, obs, low)
        g_ref = at_z["grad"]
        g_obs = torch.linalg.vector_norm(g_ref - z)
        up_e = _std_units(rda.upsample(rda.increment(dec, z), hw))
        adv = rda.advance(fc, kp["xa"])
        adv_n = torch.linalg.vector_norm(_std_units(adv - mean))
        last_n = torch.linalg.vector_norm(_std_units(at_z["last"] - mean))

        def numbers(inc, xb_next, jo, drop, grad, last):
            d_ref = at_z["j"] - j0_ref
            return {"inc_gap": _rel(_std_units(inc), up_e),
                    "jo_gap": abs(jo - at_z["jo"]) / abs(at_z["jo"] - jo_bg),
                    "drop_gap": abs(drop - d_ref) / -d_ref if d_ref < 0 else float("inf"),
                    "grad_gap": float(torch.linalg.vector_norm(grad - g_ref) / g_obs),
                    "roll_gap": float(torch.linalg.vector_norm(_std_units(last - at_z["last"]))
                                      / last_n),
                    "adv_gap": float(torch.linalg.vector_norm(_std_units(xb_next - adv))
                                     / adv_n)}

        j = [b + coeff * o for b, o in zip(entry["jb"], entry["jo"])]
        got = numbers(kp["xa"] - xb, kp["xb_next"], entry["jo"][-1], j[-1] - j[0], kp["grad"],
                      kp["last"])
        for name, v in got.items():
            worst[name] = max(worst[name], v)
        if ctx.control:
            c8 = rwin.window_cost(dec, flow, z, xb, obs, coeff, "fp8", grad=True)
            j8_0 = rwin.window_cost(dec, flow, zero, xb, obs, coeff, "fp8")["j"]
            got = numbers(rda.upsample(rda.increment(dec, z, "fp8"), hw),
                          rda.advance(fc, kp["xa"], "fp8"), c8["jo"], c8["j"] - j8_0,
                          c8["grad"], c8["last"])
            for name, v in got.items():
                worst_ctl[name] = max(worst_ctl[name], v)
            del c8
        del kp, obs, at_z, g_ref, up_e, adv
    checks = [harness.Check(name, v, limits[name]) for name, v in worst.items()]
    control = ([harness.Check(name, v, limits[name]) for name, v in worst_ctl.items()]
               if ctx.control else [])
    return checks, control
