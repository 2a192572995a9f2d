"""Driver of a cycled-DA cell: the port's CycledDA as run_da builds it.

Set-up: the decoder and the forecast model from the seed (weights.draw),
the synthetic truth on the device (synth.DeviceEra5), a CycledDA over a
scratch work dir, then one `run_assimilation` over 1 + n 6 h cycles
(n = round(seconds / the cell's cycle_s_hint)), plus one profiled cycle
with --trace 1. The first cycle (with the spin-up before it) is set-up:
`setup_s` runs from the process's start to its end. The window is the n
cycles after it, end to end on the host's clock, nothing left out between
them: `s_per_cycle` is its length over n. The harness sees the loop
through three wrappers that change no number: the forecast callable it
hands CycledDA, the solver's `solve`, and the cycle-seconds list, whose
append marks each cycle's end. `peak_mem_gib.da` leaves out what the
benchmark holds on the device (the truth's fields and the buffers of the
check), which a run of run_da would not.

Check, once the window has closed and the program is freed: for
`check_cycles` of the window's cycles drawn from the seed, the plain
float32 reference (reference/) works out again, from the control z the
solve returned, the background xb and the truth, the analysis increment,
the reduced obs term, the cost and its gradient, and advances the
program's analysis:

- `inc_gap`: |xa - xb - up(dec(z) s)| / |up(dec(z) s)|, in units of each
  channel's std;
- `jo_gap`: the program's Jo at z against the reference's, over the part
  of Jo that the increment sets (Jo(z) - c / 2);
- `drop_gap`: the program's J(z) - J(0) against the reference's; infinite
  where the reference's J did not fall;
- `grad_gap`: |g - g_ref| / |g_ref - z| at z, g the gradient of the
  program's own cost (the solver's, through the decoder's backward, asked
  once the window has closed, on the reduced obs the solve was given),
  over the part of the gradient that the decoder sets;
- `adv_gap`: |xb_next - F(xa)| / |F(xa) - mean|, in std units;

each the worst over the cycles checked, held to the cell's `limits`. The
background xb is the program's own state (its previous advance), checked
by `adv_gap` of the cycle before.
"""

from __future__ import annotations

import functools
import gc
import random
import sys
import time
from datetime import datetime

import torch

import harness
import models
from metrics import _flops
from reference import channels
from reference import da as rda


class _Cycles(list):
    """CycledDA's cycle-seconds list: each append is a cycle's end."""

    def __init__(self, on_end):
        super().__init__()
        self.on_end = on_end

    def append(self, secs):
        super().append(secs)
        self.on_end(len(self))


def _std_units(x):
    std = torch.as_tensor(channels.STD, dtype=torch.float32, device=x.device)
    return x / std[:, None, None]


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def run(ctx: harness.Ctx) -> harness.Outcome:
    from devtrace import DeviceTrace
    from synth import DeviceEra5
    from vaevar_tpu_torch.config import DAConfig
    from vaevar_tpu_torch.da.cost import ReducedObs
    from vaevar_tpu_torch.da.cycler import CYCLE, CycledDA
    from vaevar_tpu_torch.da.dynamics import make_integrate
    from vaevar_tpu_torch.da.lbfgs import value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False  # as run_da
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = ctx.config, ctx.cell["params"]
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    n = max(1, round(ctx.seconds / traffic["cycle_s_hint"]))
    total = 1 + n + int(ctx.trace)
    sampled = sorted(random.Random(ctx.seed).sample(range(1, n + 1),
                                                    min(traffic["check_cycles"], n)))
    da_cfg = dict(cfg["da"], save_interval=cfg["save_interval"])

    decoder = models.program_model(cfg["models"]["decoder"], ctx.seed, "decoder", dev)
    forecast = models.program_model(cfg["models"]["forecast"], ctx.seed, "forecast", dev)
    for m in (decoder, forecast):
        m.eval().requires_grad_(False)
    source = DeviceEra5(da_cfg["grid_hw"], ctx.seed, dev)

    # the checked cycles' control, background, analysis and next background,
    # copied into buffers made now: the same device memory for every seed
    state = (len(channels.MEAN), *da_cfg["grid_hw"])
    low = (len(channels.MEAN), *da_cfg["solver_hw"])
    keep = {k: {"z": torch.empty(da_cfg["latent_shape"], device=dev),
                **{name: torch.empty(state, device=dev) for name in ("xb", "xa", "xb_next")},
                **{name: torch.empty(low, device=dev) for name in ("a", "b")},
                "c": torch.empty((), device=dev)}
            for k in sampled}
    held = sum(t.numel() * t.element_size() for kp in keep.values() for t in kp.values())
    held += sum(t.numel() * t.element_size() for t in (source.base, source.mode2))
    ends, advance_s = [], {}
    tracer = DeviceTrace(ctx.scratch) if ctx.trace else None
    peaks = {}

    def mark(label):
        if tracer is not None:
            tracer.mark(label)

    def on_end(k):
        ends.append(time.perf_counter())
        if cuda and k in (1, 1 + n):
            peaks[k] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        if tracer is not None and k == 1 + n:
            tracer.start("obs take, scoring, reduction")
        elif tracer is not None and k == 2 + n:
            tracer.stop()
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
                  source, forecast_integrate, decoder, work_dir=str(work_dir),
                  seed=ctx.seed, device=str(dev), verbose=False,
                  prefetch_obs=traffic["prefetch_obs"])
    da.timings["cycle_s"] = _Cycles(on_end)
    solve = da._solver.solve

    def solve_and_keep(x0, bundle, **kw):
        k = len(ends)
        mark("solve")
        z, xa, diag = solve(x0, bundle, **kw)
        if k in keep:
            for name, t in (("z", z), ("xb", bundle.xb), ("xa", xa), ("a", bundle.a),
                            ("b", bundle.b), ("c", bundle.c)):
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
    for k, c in enumerate(log[:1 + n]):
        print(f"portbench: cycle {k}: {c['seconds']:.3f} s, solve "
              f"{c['solve_s']:.3f} s, evals {sum(c['n_evals'])} ({sum(c['n_jvp'])} jvp)",
              file=sys.stderr, flush=True)
    for k in sampled:  # the program's own cost gradient at the kept z, off the clock
        kp = keep[k]
        bundle = ReducedObs(xb=kp["xb"], a=kp["a"], b=kp["b"], c=kp["c"])
        kp["grad"] = value_and_grad(functools.partial(da._solver.cost, bundle=bundle),
                                    kp["z"])[1]
    data = {
        "cycle_log": log[1:1 + n], "window_s": window_s, "advance_s": advance_s,
        "obs_coeff": da_cfg["obs_coeff"], "peak_window_bytes": peak_window,
        "harness_bytes": held, "trace": reading,
        "model_flops": {role: _flops.lgunet_forward_flops(cfg["models"][role])
                        for role in ("decoder", "forecast")},
    }
    e2e = {"setup_s": ends[0] - ctx.start, "s_per_cycle": window_s / n}
    failed = sum(not (c["xa_finite"] and c["xb_next_finite"]) for c in log[1:1 + n])
    del da, solve, decoder, forecast, integrate, bundle
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
    fc = models.reference_model(cfg["models"]["forecast"], ctx.seed, "forecast", dev)
    for m in (dec, fc):
        m.eval().requires_grad_(False)
    hw, low = tuple(da_cfg["grid_hw"]), tuple(da_cfg["solver_hw"])
    columns = rda.column_draws(ctx.seed, da_cfg["obs_type"], max(sampled) + 1, hw)
    var = rda.obs_error_variance(da_cfg["obs_std"], da_cfg["modify_tp"])
    coeff = da_cfg["obs_coeff"]
    worst = {"inc_gap": 0.0, "jo_gap": 0.0, "drop_gap": 0.0, "grad_gap": 0.0, "adv_gap": 0.0}
    worst_ctl = dict(worst)
    for k in sampled:
        kp, entry = keep[k], log[k]
        z, xb = kp["z"], kp["xb"]
        obs = rda.ObsTerm(source.state(start + k * cycle), xb, columns[k], var, low)
        e = rda.increment(dec, z)
        j0_ref = rda.cost(torch.zeros_like(z), rda.increment(dec, torch.zeros_like(z)), obs,
                          coeff)[0]
        jz_ref, _, jo_ref = rda.cost(z, e, obs, coeff)
        g_ref = rda.gradient(dec, z, obs, coeff)
        g_dec = torch.linalg.vector_norm(g_ref - z)
        up_e = _std_units(rda.upsample(e, hw))
        adv = rda.advance(fc, kp["xa"])
        adv_n = _std_units(adv - torch.as_tensor(channels.MEAN, dtype=torch.float32,
                                                 device=dev)[:, None, None])

        def numbers(inc, xb_next, jo, drop, grad):
            d_ref = jz_ref - j0_ref
            return {"inc_gap": _rel(_std_units(inc), up_e),
                    "jo_gap": abs(jo - jo_ref) / abs(jo_ref - 0.5 * obs.c),
                    "drop_gap": abs(drop - d_ref) / -d_ref if d_ref < 0 else float("inf"),
                    "grad_gap": float(torch.linalg.vector_norm(grad - g_ref) / g_dec),
                    "adv_gap": float(torch.linalg.vector_norm(_std_units(xb_next - adv))
                                     / torch.linalg.vector_norm(adv_n))}

        j = [b + coeff * o for b, o in zip(entry["jb"], entry["jo"])]
        got = numbers(kp["xa"] - xb, kp["xb_next"], entry["jo"][-1], j[-1] - j[0], kp["grad"])
        for name, v in got.items():
            worst[name] = max(worst[name], v)
        if ctx.control:
            e8 = rda.increment(dec, z, "fp8")
            e8_0 = rda.increment(dec, torch.zeros_like(z), "fp8")
            j8 = rda.cost(z, e8, obs, coeff)[0] - rda.cost(torch.zeros_like(z), e8_0, obs,
                                                          coeff)[0]
            got = numbers(xb + rda.upsample(e8, hw) - xb, rda.advance(fc, kp["xa"], "fp8"),
                          obs.value(e8), j8, rda.gradient(dec, z, obs, coeff, "fp8"))
            for name, v in got.items():
                worst_ctl[name] = max(worst_ctl[name], v)
        del kp, obs, e, up_e, adv, adv_n, g_ref
    checks = [harness.Check(name, v, limits[name]) for name, v in worst.items()]
    control = ([harness.Check(name, v, limits[name]) for name, v in worst_ctl.items()]
               if ctx.control else [])
    return checks, control
