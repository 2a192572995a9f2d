"""The 4D-Var window cycle under each `--win_remat` setting, on one card.

    python3 scripts/window_remat.py [none step block both]

Runs the window phase of chip_smoke.py (`check_window`: one da_win 6 cycle
of `run_da` at 721x1440 over 128x256, FLOW_140 inside J, bf16, random
weights from seed 0, from the truth) once per setting, in the order given
(default: all four), in one process, and fails as the phase does. For each
it prints the cycle's seconds, iterations, charged evals, jvp probes and
peak device memory, then the window cost's probes (`time_window_evals`).
`both` is run_da's default: block remat of the decoder and FLOW_140, and one
checkpoint per rollout step; `none` keeps every activation for the backward.
Needs one CUDA card.
"""

from __future__ import annotations

import gc
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

SETTINGS = ("none", "step", "block", "both")


def time_window_evals(da, reps=3):
    """Host-clock seconds (median of `reps`, synchronised) of the window
    cost's evaluations on the cycle's models and shapes: a forward, a
    reverse probe (value and gradient: forward, remat recompute, backward),
    a jvp probe (value and slope by torch.func.jvp, as the port runs it) and,
    as a yardstick the port does not use, the same slope through
    torch.autograd.forward_ad dual tensors; then each one's device time
    (torch.profiler, kernels summed), its share of the unprofiled time and
    its kernel count, and the probes' aten ops that take the most host
    time. Prints one line each."""
    import torch
    import torch.autograd.forward_ad as fwAD
    from torch.profiler import ProfilerActivity, profile

    from vaevar_tpu_torch.da import cost as cost_mod
    from vaevar_tpu_torch.da import lbfgs
    from vaevar_tpu_torch.da.cycler import parse_time

    dev = torch.device(da.device)
    yo, H, R, gt = da.get_obs_info(parse_time(da.cycle_log[0]["time"]))
    bundle = da._reduce_obs(cost_mod.ObsBundle(gt[0], yo, H, R), da.cfg.solver_hw)
    del yo, H, R, gt
    gen = torch.Generator().manual_seed(7)
    z = (0.1 * torch.randn(da.cfg.latent_shape, generator=gen)).to(dev)
    u = torch.randn(da.cfg.latent_shape, generator=gen).to(dev)

    def fun(q):
        return da._solver.cost(q, bundle)

    def forward():
        with torch.no_grad():
            fun(z)

    def dual_probe():
        with torch.no_grad(), fwAD.dual_level():
            return fwAD.unpack_dual(fun(fwAD.make_dual(z, u)))

    def timed(fn):
        out = []
        for _ in range(reps + 1):  # the first call warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out[1:])

    def profiled(fn):
        """(device seconds, kernel count, the 6 aten ops of most self host
        time as 'name count x ms')."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        ops = sorted((a for a in prof.key_averages() if a.key.startswith("aten::")),
                     key=lambda a: -a.self_cpu_time_total)[:6]
        return (1e-6 * sum(e.time_range.elapsed_us() for e in kernels), len(kernels),
                ", ".join(f"{a.key} {a.count} x {a.self_cpu_time_total / 1e3:.0f} ms"
                          for a in ops))

    fns = {"forward": forward, "reverse probe": lambda: lbfgs.value_and_grad(fun, z),
           "jvp probe": lambda: lbfgs.value_and_slope(fun, z, u),
           "dual-tensor probe": dual_probe}
    t = {k: timed(fn) for k, fn in fns.items()}
    chip_smoke.phase("window", "window cost evaluations (host clock, synchronised, median "
                     f"of {reps}): " + ", ".join(f"{k} {v:.3f} s" for k, v in t.items())
                     + f"; jvp / reverse probe {t['jvp probe'] / t['reverse probe']:.2f}")
    prof = {k: profiled(fn) for k, fn in fns.items()}
    chip_smoke.phase("window", "device time (profiler, kernels summed): " + ", ".join(
        f"{k} {v:.3f} s in {n} kernels ({v / t[k]:.0%} of its time)"
        for k, (v, n, _) in prof.items()))
    for k in ("reverse probe", "jvp probe"):
        chip_smoke.phase("window", f"{k}: aten ops of most self host time (profiled): "
                         f"{prof[k][2]}")


def main(argv=None):
    import torch

    settings = sys.argv[1:] if argv is None else argv
    settings = settings or list(SETTINGS)
    unknown = sorted(set(settings) - set(SETTINGS))
    if unknown:
        raise SystemExit(f"window_remat: unknown settings {unknown}; choose from {SETTINGS}")
    if not torch.cuda.is_available():
        raise SystemExit("window_remat: no CUDA device available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)

    from vaevar_tpu_torch.ops import flash_attn as fa

    for s in settings:
        _, da = chip_smoke.check_window(fa, ["--win_remat", s])
        time_window_evals(da)
        del da
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
